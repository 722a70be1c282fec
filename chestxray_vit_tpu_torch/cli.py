"""Command-line entry points of the port, from ``chestxray_vit_tpu/cli.py``.

    python -m chestxray_vit_tpu_torch.cli train --preset version_b \\
        --set data.use_subset_data=1000 --set train.output_dir=./outputs
    python -m chestxray_vit_tpu_torch.cli eval --preset version_b \\
        --set train.resume_from_checkpoint=auto
    python -m chestxray_vit_tpu_torch.cli predict ...  # + classification report
    python -m chestxray_vit_tpu_torch.cli smoke        # synthetic end-to-end run
    python -m chestxray_vit_tpu_torch.cli maps a.png --model-dir outputs/model
    python -m chestxray_vit_tpu_torch.cli export --model-dir outputs/model \\
        --out hf_folder
    python -m chestxray_vit_tpu_torch.cli quantize --model-dir outputs/model \\
        --calibration a.png b.png
    python -m chestxray_vit_tpu_torch.cli serve --model-dir outputs/model

``--device DEVICE`` (default ``cuda``; ``cpu`` runs the plain kernel
twins) may stand anywhere after the command, for every command; ``serve``
takes it as the server's own flag. ``train`` starts from the HF weights
that ``model.model_name`` names (a local HF folder, e.g. one ``export``
wrote, or a ``.safetensors`` file; hub names need ``transformers`` and a
cache), and from random weights where they cannot be read.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

from chestxray_vit_tpu_torch.config import Config, parse_cli


def _pop_device(argv: List[str]) -> Tuple[str, List[str]]:
    """(the ``--device`` value or 'cuda', argv without the option)."""
    device, rest, i = "cuda", [], 0
    while i < len(argv):
        if argv[i] == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 2
            continue
        if argv[i].startswith("--device="):
            device = argv[i].partition("=")[2]
        else:
            rest.append(argv[i])
        i += 1
    return device, rest


def _build_trainer(cfg: Config, device: str, pretrained: bool = True):
    from chestxray_vit_tpu_torch.train.trainer import Trainer
    store = None
    if cfg.data.backend == "memory":
        from chestxray_vit_tpu_torch.data.testing import build_fake_nih
        store = build_fake_nih(num_images=max(
            64, (cfg.data.use_subset_data or 0) + 32)).store
    return Trainer(cfg, store=store, pretrained=pretrained, device=device)


def _restore(trainer, cfg: Config) -> None:
    if cfg.train.resume_from_checkpoint:
        step = (None if cfg.train.resume_from_checkpoint == "auto"
                else int(cfg.train.resume_from_checkpoint))
        trainer.state, _, _ = trainer.ckpt.restore(step, trainer.state)


def cmd_train(cfg: Config, device: str) -> int:
    trainer = _build_trainer(cfg, device)
    metrics = trainer.train()
    trainer.save_model()
    eval_metrics = trainer.evaluate()
    trainer.logger.log(int(trainer.state.step), eval_metrics, "eval")
    trainer.logger.save_results("eval", eval_metrics)
    trainer.save_state()       # trainer_state.json
    trainer.close()
    print({**metrics, **eval_metrics})
    return 0


def cmd_eval(cfg: Config, device: str) -> int:
    trainer = _build_trainer(cfg, device)
    _restore(trainer, cfg)
    metrics = trainer.evaluate()
    trainer.logger.save_results("eval", metrics)
    trainer.close()
    print(metrics)
    return 0


def cmd_predict(cfg: Config, device: str) -> int:
    trainer = _build_trainer(cfg, device)
    _restore(trainer, cfg)
    report = os.path.join(os.path.expanduser(cfg.train.output_dir),
                          "final_classification_report.txt")
    # --set train.calibrate_thresholds=1 fits per-class thresholds on val
    _, _, metrics = trainer.predict(
        report_path=report,
        calibrate=cfg.train.calibrate_thresholds)
    trainer.close()
    print(metrics)
    return 0


def cmd_smoke(cfg: Config, device: str) -> int:
    """Synthetic-bucket end-to-end sanity fine-tune, narrowed as the JAX
    smoke is: hidden 64 in four heads of 16, two layers, 64 px."""
    cfg.data.backend = "memory"
    cfg.data.use_subset_data = cfg.data.use_subset_data or 48
    cfg.model.img_size = min(cfg.model.img_size, 64)
    cfg.model.num_layers = min(cfg.model.num_layers, 2)
    cfg.model.hidden_size = min(cfg.model.hidden_size, 64)
    cfg.model.num_heads = 4
    cfg.model.mlp_dim = min(cfg.model.mlp_dim, 128)
    cfg.model.attention_impl = "auto"
    cfg.train.num_epochs = min(cfg.train.num_epochs, 3)
    cfg.train.eval_strategy = "epoch"
    cfg.train.save_strategy = "epoch"
    cfg.train.logging_steps = 1
    trainer = _build_trainer(cfg, device, pretrained=False)
    trainer.train()
    metrics = trainer.evaluate()
    trainer.close()
    print({"smoke": "ok", **{k: round(v, 4) for k, v in metrics.items()
                             if not k.startswith("auroc_")}})
    return 0


def cmd_maps(argv: List[str], device: str) -> int:
    """Attention-rollout or Grad-CAM overlays for a saved model (the HTTP
    server serves the rollout through /predict?maps=1)."""
    import argparse
    ap = argparse.ArgumentParser(prog="chestxray_vit_tpu_torch maps")
    ap.add_argument("images", nargs="+", help="PNG/JPEG files")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--alpha", type=float, default=0.45)
    ap.add_argument("--method", choices=("rollout", "gradcam"),
                    default="rollout",
                    help="rollout: attention flow from CLS; gradcam: "
                         "class-discriminative (top predicted class)")
    ns = ap.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from chestxray_vit_tpu_torch.data import decode as dec
    from chestxray_vit_tpu_torch.serve import attention_maps as am
    from chestxray_vit_tpu_torch.serve.inference import Predictor

    pred = Predictor.from_model_dir(ns.model_dir, device=device)
    blobs = []
    for path in ns.images:
        with open(path, "rb") as f:
            blobs.append(f.read())
    if ns.method == "gradcam":
        plain = pred.predict_bytes(blobs)
        cls = np.argmax(plain.probs, axis=1)
        params, bs, cams = pred._dense_params(), pred.batch_size, []
        for lo in range(0, len(blobs), bs):
            chunk = blobs[lo:lo + bs]
            with pred._on_stream():
                with torch.inference_mode():
                    x = pred._images_of(pred.stage_chunk(chunk))
                # out of inference mode: Grad-CAM differentiates the
                # block inputs computed from it
                _, cam = am.grad_cam(params, x[:len(chunk)].clone(),
                                     pred.cfg,
                                     torch.from_numpy(cls[lo:lo + bs]))
                cams.append(cam.float().cpu().numpy())
        maps_np, probs_np = np.concatenate(cams), plain.probs
    else:
        out = pred.predict_bytes(blobs, with_maps=True)
        maps_np, probs_np = out.maps, out.probs
    out_dir = os.path.expanduser(ns.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    for path, blob, m, probs in zip(ns.images, blobs, maps_np, probs_np):
        gray = dec.safe_decode_gray(blob)
        overlay = am.render_overlay(gray, np.asarray(m), ns.alpha)
        stem = os.path.splitext(os.path.basename(path))[0]
        dest = os.path.join(out_dir, f"{stem}_attn.png")
        Image.fromarray(overlay, "RGB").save(dest)
        top = pred.top_findings(probs, k=3)
        print(f"{path} -> {dest}  top: " + ", ".join(
            f"{f['label']}={f['probability']:.3f}" for f in top))
    return 0


def _load_saved(model_dir: str):
    """(Config, port ViT on the CPU, classes) of a save_model directory."""
    from chestxray_vit_tpu_torch.models import vit
    from chestxray_vit_tpu_torch.train.checkpoint import load_model

    with open(os.path.join(os.path.expanduser(model_dir),
                           "config.json")) as f:
        cfg = Config.from_json(f.read())
    params, classes = load_model(model_dir, vit.ViT(cfg.model))
    return cfg, params, classes


def cmd_export(argv: List[str], device: str) -> int:
    """Export a saved model dir to an HF ViTForImageClassification folder
    (torch ``from_pretrained``-loadable; the port's ``train`` reads it back
    through ``model.model_name``). Runs on the host: ``--device`` is not
    used."""
    import argparse
    ap = argparse.ArgumentParser(prog="chestxray_vit_tpu_torch export")
    ap.add_argument("--model-dir", required=True,
                    help="a Trainer save_model() directory")
    ap.add_argument("--out", required=True, help="HF folder to write")
    ns = ap.parse_args(argv)

    from chestxray_vit_tpu_torch.models.export_hf import export_hf_folder

    cfg, params, classes = _load_saved(ns.model_dir)
    export_hf_folder(ns.out, params, cfg.model, classes,
                     image_mean=cfg.data.image_mean,
                     image_std=cfg.data.image_std)
    print(f"HF export written to {ns.out}")
    return 0


def cmd_quantize(argv: List[str], device: str) -> int:
    """Quantize a saved model once and persist the int8 artifact
    (``<model-dir>/quantized/``): serving cold starts
    (``serve --quantize``, ``Predictor.from_model_dir``) then skip the
    quantize pass and, for static mode, the calibration forward."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="chestxray_vit_tpu_torch quantize",
        epilog="The JAX CLI's --compilation-cache (a persistent XLA "
               "compile cache) has no counterpart here and is not "
               "accepted.")
    ap.add_argument("--model-dir", required=True,
                    help="a Trainer save_model() directory")
    ap.add_argument("--mode", choices=("static", "dynamic"),
                    default="static")
    ap.add_argument("--calibration", nargs="*", default=None,
                    help="PNG/JPEG files for static calibration "
                         "(synthetic-noise fallback when omitted — pass "
                         "real images for production)")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default "
                         "<model-dir>/quantized)")
    ns = ap.parse_args(argv)

    from chestxray_vit_tpu_torch.serve.inference import Predictor

    calibration = None
    if ns.calibration is not None:
        if not ns.calibration:
            # an explicit but empty list (a shell glob that matched
            # nothing) must not fall back to synthetic noise
            raise SystemExit("--calibration was given but matched no "
                             "files; pass image paths or omit the flag "
                             "for the synthetic fallback")
        calibration = []
        for path in ns.calibration:
            with open(path, "rb") as f:
                calibration.append(f.read())
    # built fresh (never via from_model_dir, which would load an existing
    # artifact instead of re-quantizing)
    cfg, params, classes = _load_saved(ns.model_dir)
    pred = Predictor(params, cfg.model, classes, quantize=ns.mode,
                     calibration=calibration, device=device)
    out = ns.out or os.path.join(os.path.expanduser(ns.model_dir),
                                 "quantized")
    pred.save_quantized(out)
    print(f"int8 artifact ({ns.mode}) written to {out}")
    return 0


COMMANDS = {
    "train": cmd_train,
    "eval": cmd_eval,
    "predict": cmd_predict,
    "smoke": cmd_smoke,
}
TOOLS = {
    "maps": cmd_maps,
    "export": cmd_export,
    "quantize": cmd_quantize,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(sorted([*COMMANDS, *TOOLS, "serve"])))
        return 0
    cmd = argv.pop(0)
    if cmd == "serve":
        # the HTTP server, with its own flags (--model-dir, --device, ...)
        from chestxray_vit_tpu_torch.serve.server import main as serve_main
        return serve_main(argv)
    if cmd not in COMMANDS and cmd not in TOOLS:
        print(f"unknown command {cmd!r}; one of "
              f"{sorted([*COMMANDS, *TOOLS, 'serve'])}")
        return 2
    device, argv = _pop_device(argv)
    if cmd in TOOLS:
        return TOOLS[cmd](argv, device)
    return COMMANDS[cmd](parse_cli(argv), device)


if __name__ == "__main__":
    raise SystemExit(main())

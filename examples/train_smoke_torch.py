"""Smallest end-to-end example of the PyTorch port: synthetic NIH bucket →
fine-tune → eval → predictions with attention maps. No data needed; runs
on the card (``--device cpu`` for the CPU). The counterpart of
``examples/train_smoke.py``.

    python examples/train_smoke_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs (the card unless asked)")
    ns = ap.parse_args(argv)

    from chestxray_vit_tpu_torch.config import (Config, DataConfig,
                                                ModelConfig, TrainConfig)
    from chestxray_vit_tpu_torch.data.testing import build_fake_nih
    from chestxray_vit_tpu_torch.serve.inference import Predictor
    from chestxray_vit_tpu_torch.train.trainer import Trainer

    fake = build_fake_nih(num_images=96, image_size=64)
    cfg = Config(
        data=DataConfig(backend="memory"),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128),
        train=TrainConfig(batch_size_per_core=4, learning_rate=1e-3,
                          num_epochs=3, eval_strategy="epoch",
                          save_strategy="epoch", logging_steps=5,
                          output_dir="./smoke_outputs", report_to="none"),
    )
    trainer = Trainer(cfg, store=fake.store, pretrained=False,
                      device=ns.device)
    trainer.train()
    print("eval:", {k: round(v, 3) for k, v in trainer.evaluate().items()
                    if not k.startswith("auroc_")})
    trainer.save_model()
    trainer.close()

    pred = Predictor.from_model_dir("./smoke_outputs/model", batch_size=4,
                                    device=ns.device)
    blob = fake.store.get("images_001/images/" + fake.image_names[0])
    out = pred.predict_bytes([blob], with_maps=True)
    print("top findings:", pred.top_findings(out.probs[0], k=3))
    print("attention map grid:", out.maps.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

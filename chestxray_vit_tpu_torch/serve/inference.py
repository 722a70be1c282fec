"""Batched inference for serving, ported from
``chestxray_vit_tpu/serve/inference.py`` (the dense and int8 paths, with
or without token merging, and attention-rollout maps).

Images come in as encoded bytes or decoded u8 grayscale arrays. The host
half (``stage_chunk``) decodes, crops, pads to a power-of-two bucket and
starts the host→device copy; the device half (``forward_staged``) runs the
ViT forward and pulls the logits, and the host takes the sigmoid. The
port's ``serve.batcher.MicroBatcher`` runs the two halves on two threads.

The Predictor holds one weight replica per device (one, or N under
``data_parallel``) and one CUDA stream per replica. Both halves enqueue a
replica's work on its stream, so the copy of a batch is ordered before the
forward that reads it whatever thread calls either half. The copies read
pinned host buffers; PyTorch's pinned-memory allocator does not hand a
buffer out again before the copy that read it has finished.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import Config, ModelConfig
from chestxray_vit_tpu_torch.data import decode as dec
from chestxray_vit_tpu_torch.data import geometry as geo
from chestxray_vit_tpu_torch.models import quantized, tome_forward, vit
from chestxray_vit_tpu_torch.ops.preprocess import (fused_preprocess,
                                                    normalize_u8)
from chestxray_vit_tpu_torch.ops.tome import r_schedule
from chestxray_vit_tpu_torch.serve import attention_maps
from chestxray_vit_tpu_torch.train.checkpoint import load_model, local_dir


@dataclass
class PredictOutput:
    probs: np.ndarray                       # [N, C]
    logits: np.ndarray                      # [N, C]
    classes: Optional[List[str]] = None
    maps: Optional[np.ndarray] = None       # [N, g, g] attention rollout


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: an unindexed card is the current one."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replica_devices(device, data_parallel, batch_size: int
                    ) -> List[torch.device]:
    """The devices of a Predictor's weight replicas, one per replica.

    ``device`` is one device, or a sequence of devices (repeats allowed),
    one per replica; ``data_parallel`` is then unset (False, None, 0 or
    True) or the sequence's length. With one device, ``data_parallel``
    False, 0 or 1 gives that device alone, True every visible device of
    its type and an int N the first N (``cuda:0`` … ``cuda:N-1``); the CPU
    is one device. Refused as the JAX Predictor refuses: N < 1, more than
    the visible devices, a batch size that N does not divide."""
    if isinstance(device, (list, tuple)):
        devices = [_indexed(torch.device(d)) for d in device]
        unset = (data_parallel is None or isinstance(data_parallel, bool)
                 or data_parallel == 0)
        if not devices or (not unset and data_parallel != len(devices)):
            raise ValueError(f"data_parallel={data_parallel!r} does not "
                             f"match the {len(devices)} devices given")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"replica devices of several types: {devices}")
    else:
        dev = torch.device(device)
        visible = torch.cuda.device_count() if dev.type == "cuda" else 1
        n = visible if data_parallel is True else int(data_parallel or 1)
        if n < 1:
            raise ValueError(f"data_parallel={n} must be >= 1 (or True for "
                             f"all devices)")
        if n > visible:
            raise ValueError(f"data_parallel={n} > {visible} devices")
        devices = ([_indexed(dev)] if n == 1 else
                   [torch.device(dev.type, i) for i in range(n)])
    if batch_size % len(devices):
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"data_parallel {len(devices)}")
    return devices


class Predictor:
    """Serving wrapper around a port ``ViT`` (``models.vit``).

    ``placement`` picks where crop/pad/resize runs: 'host' (decode and
    crop/pad/resize on the host, u8 img² per image crosses to the device)
    or 'device' (u8 canvases + crop boxes cross, and ``fused_preprocess``
    runs on the device). ``device`` is where the forward runs; 'cuda'
    without a card raises.

    ``quantize`` serves the int8 forward (``models/quantized.py``), with
    per-channel int8 weights prepared here once:

    - ``True`` / ``'dynamic'``: per-token dynamic activation scales, on the
      plain route (``backend="xla"``: the library int8 product and an eager
      epilogue);
    - ``'static'``: per-site scales calibrated once on ``calibration`` (u8
      grayscale arrays or encoded images, staged as requests are;
      ``'synthetic'`` for a seeded noise batch; None warns and uses that
      batch), served through the fused int8 kernel (``backend="pallas"``).
      The JAX ``Predictor`` serves static trees on its "xla" route, a
      choice it made from TPU measurements; the two routes differ only in
      where bf16 rounds around the GELU and the requantize.

    ``qparams`` injects a prebuilt quantized tree (``load_quantized`` or
    ``quantize_vit_params``), moved to ``device``, skipping the quantize
    pass and, for static mode, the calibration forward; its mode must
    match ``quantize``.

    ``tome_r`` merges up to r token pairs per layer (token merging,
    ``models/tome_forward.apply_tome``; ``tome_schedule`` 'constant' or
    'decreasing' spreads the r·L budget), composed with any ``quantize``:
    static trees merge on the fused route, dynamic ones on the plain one.
    Merging is lossy; validate it on your data. The dense tree's LayerNorm
    gains are held in the compute dtype, as ``vit.apply`` rounds them (the
    JAX Predictor's merged dense forward reads them in f32).

    ``with_maps=True`` (``forward_staged``, ``predict_bytes``,
    ``predict_arrays``, ``warmup``) runs the attention-rollout forward
    (``serve/attention_maps.compute_rollout``) instead: the full-token
    dense model whatever ``quantize`` and ``tome_r`` serve, its logits
    returned beside [N, g, g] maps in [0, 1], as the JAX Predictor does. A
    quantized Predictor builds that dense tree on its stream at the first
    maps forward or at ``warmup(with_maps=True)``.

    ``data_parallel`` serves each micro-batch over several devices from
    one process (``True`` = every visible card, an int = the first N; see
    :func:`replica_devices`), as the JAX Predictor shards it over a
    ``data`` mesh: one weight replica and one stream per device, replica
    i takes rows [i·b/N, (i+1)·b/N) of the padded bucket b, the logits
    (and maps) are gathered in replica order, and buckets round up to a
    multiple of N. ``device`` may instead be a sequence of devices, one
    per replica, repeats allowed: ``["cpu"] * 4`` holds four replicas on
    the CPU (the tests' stand-in for the JAX package's virtual devices),
    ``["cuda:0"] * 2`` two on one card, each on its own stream. Static
    calibration runs once, on replica 0, and every replica serves a copy
    of that one int8 tree. Composes with ``placement``, ``quantize``,
    ``tome_r`` and ``with_maps``.

    :meth:`from_model_dir` loads a ``Trainer.save_model()`` directory.
    """

    def __init__(self, params: vit.ViT, cfg: ModelConfig,
                 classes: Optional[Sequence[str]] = None,
                 batch_size: int = 8, canvas_size: int = 1024,
                 placement: str = "host", device="cuda",
                 quantize=False, calibration=None, data_parallel=False,
                 qparams: Optional[quantized.QuantizedViT] = None,
                 tome_r: int = 0, tome_schedule: str = "constant"):
        if placement not in ("host", "device"):
            raise ValueError(f"unknown placement {placement!r}")
        if quantize in (False, None):
            qmode = None
        elif quantize in (True, "dynamic"):
            qmode = "dynamic"
        elif quantize == "static":
            qmode = "static"
        else:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if qmode == "static" and cfg.gelu_approximate:
            raise ValueError("quantize='static' serves through the fused "
                             "int8 kernel, which computes the exact-erf "
                             "GELU; gelu_approximate is not supported")
        named = device if isinstance(device, (list, tuple)) else [device]
        if (any(torch.device(d).type == "cuda" for d in named)
                and not torch.cuda.is_available()):
            raise RuntimeError("Predictor(device='cuda') but no CUDA device "
                               "is available")
        self.devices = replica_devices(device, data_parallel, batch_size)
        self.device = self.devices[0]
        self.params = params
        self.cfg = cfg
        self.classes = list(classes) if classes else None
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        self.placement = placement
        self.quantize = qmode is not None
        self.quantize_mode = qmode
        self.forwards = 0           # forward_staged calls (batches)
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.devices]
        self._maps_trees: List[Optional[vit.ViT]] = [None] * self.replicas
        if qparams is not None:
            saved = "static" if qparams.static else "dynamic"
            if saved != qmode:
                raise ValueError(f"prebuilt qparams are {saved!r} but "
                                 f"quantize={qmode!r} was requested")
        # each replica's weights on its own stream, which every forward of
        # that replica runs on: they are ready before its first forward
        with self._on_stream(0):
            if qmode is None:
                tree = vit.inference_params(params, self.device)
            elif qparams is not None:
                tree = qparams.to(self.device)
            else:
                scales = (self._calibrate(calibration) if qmode == "static"
                          else None)
                tree = quantized.quantize_vit_params(params, scales,
                                                     device=self.device)
            # one int8 tree for every replica: the same bits and scales
            host = (copy.deepcopy(tree).to("cpu")
                    if self.quantize and self.replicas > 1 else None)
        self._trees = [tree]
        for r, dev in enumerate(self.devices[1:], 1):
            with self._on_stream(r):
                self._trees.append(vit.inference_params(params, dev)
                                   if host is None
                                   else copy.deepcopy(host).to(dev))
        self._fwd_params = tree     # replica 0's
        # the fused kernel for static trees, the plain route for dynamic
        self._backend = "pallas" if qmode == "static" else "xla"
        self.tome_r = int(tome_r or 0)
        self.tome_schedule = tome_schedule
        if self.tome_r:
            r_schedule(self.tome_r, cfg.num_layers, tome_schedule)  # checks
        if (self.quantize or self.tome_r) and batch_size < 16:
            # the stack pays at batch >= 32 (the server's auto_accel_config
            # crossover); configuring it below that should not be silent
            print(f"[predictor] NOTE: quantize/tome_r with batch_size="
                  f"{batch_size} < 16 may serve SLOWER than plain bf16: "
                  f"the accelerated stack is meant for batch >= 32 (the "
                  f"server's auto_accel_config crossover).", file=sys.stderr)

    def _calibrate(self, calibration) -> dict:
        """Static activation scales from the calibration images, staged
        and preprocessed as a batch of requests is."""
        if calibration is None or (isinstance(calibration, str)
                                   and calibration == "synthetic"):
            if calibration is None:
                # loud by design: static scales calibrated on noise can
                # silently ship in production
                print("[predictor] WARNING: quantize='static' with no "
                      "calibration images — activation scales will be "
                      "calibrated on seeded synthetic noise. Pass "
                      "calibration= real images (or "
                      "calibration='synthetic' to silence).",
                      file=sys.stderr)
            rng = np.random.default_rng(0)
            s = self.cfg.img_size
            calibration = [rng.integers(0, 256, (s, s), np.uint8)
                           for _ in range(8)]
        elif isinstance(calibration, str) or not len(calibration):
            raise ValueError(
                f"quantize='static' got calibration={calibration!r}: pass "
                f"real images (a non-EMPTY list), or "
                f"calibration='synthetic' explicitly")
        images = self._images_of(self._copy(
            self._stage(list(calibration), 0), 0))
        return quantized.calibrate_vit_scales(self.params, images, self.cfg)

    @classmethod
    def from_model_dir(cls, directory: str, batch_size: int = 8,
                       placement: str = "host", quantize=False,
                       data_parallel=False, tome_r: int = 0,
                       tome_schedule: str = "constant",
                       calibration=None, device="cuda") -> "Predictor":
        """Load a ``Trainer.save_model()`` directory (``config.json``,
        ``params.pt``, ``classes.json``). With ``quantize`` set, a
        ``quantized/`` artifact in the directory (written by
        :meth:`save_quantized`) is loaded instead of re-quantizing when its
        mode is the one asked for and its fingerprint is the weights'; a
        cold start then skips the quantize pass and the static calibration
        forward. A mismatched artifact is reported and ignored. The
        directory is local (a ``gs://`` one raises ``ValueError``)."""
        directory = local_dir(directory)
        with open(os.path.join(directory, "config.json")) as f:
            cfg = Config.from_json(f.read())
        params, classes = load_model(directory, vit.ViT(cfg.model))
        qparams = None
        qdir = os.path.join(directory, "quantized")
        if quantize and os.path.exists(os.path.join(qdir,
                                                    "quantized.json")):
            with open(os.path.join(qdir, "quantized.json")) as f:
                meta = json.load(f)
            saved_mode = meta.get("mode")
            want = "dynamic" if quantize is True else quantize
            if saved_mode != want:
                print(f"[predictor] quantized/ artifact is {saved_mode!r} "
                      f"but {want!r} was requested — re-quantizing from "
                      f"the f32 weights", file=sys.stderr)
            elif (meta.get("fingerprint") and meta["fingerprint"]
                  != quantized.model_fingerprint(params)):
                print("[predictor] quantized/ artifact was built from "
                      "DIFFERENT weights (model retrained since it was "
                      "saved?) — re-quantizing from the current f32 "
                      "weights", file=sys.stderr)
            else:
                qparams = quantized.load_quantized(qdir, cfg.model)
                print(f"[predictor] loaded int8 artifact ({saved_mode}) "
                      f"from {qdir}", file=sys.stderr)
        return cls(params, cfg.model, classes, batch_size,
                   placement=placement, device=device, quantize=quantize,
                   calibration=calibration, data_parallel=data_parallel,
                   qparams=qparams, tome_r=tome_r,
                   tome_schedule=tome_schedule)

    def save_quantized(self, directory: str) -> str:
        """Persist this Predictor's quantized tree (int8 weights, and the
        static scales when calibrated) as the JAX package's artifact, with
        the dense weights' fingerprint."""
        if not self.quantize:
            raise ValueError("Predictor was built without quantize=")
        return quantized.save_quantized(
            directory, self._fwd_params,
            fingerprint=quantized.model_fingerprint(self.params))

    @property
    def replicas(self) -> int:
        """Weight replicas, one per device; a forward runs each of them on
        its share of the bucket's rows."""
        return len(self.devices)

    def _on_stream(self, r: int = 0):
        """Replica ``r``'s device and stream (nothing on the CPU)."""
        stream = self._streams[r]
        if stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(self.devices[r]))
        ctx.enter_context(torch.cuda.stream(stream))
        return ctx

    def _images_of(self, staged) -> torch.Tensor:
        dtype = vit.torch_dtype(self.cfg.dtype)
        if self.placement == "device":
            canvases, boxes = staged
            return fused_preprocess(canvases, boxes,
                                    out_size=self.cfg.img_size, dtype=dtype)
        return normalize_u8(staged[0], dtype=dtype)

    # ------------------------------------------------------------------

    def _stage(self, images_bytes: Sequence, n_pad: int):
        """bytes or u8 arrays → staged host operands (zero rows for tail
        padding).

        'device': (canvases u8 [n, C, C], boxes i32 [n, 4]);
        'host':   (pixels u8 [n, img, img],) — decoded + crop/pad/resize on
        the host, so only img² bytes per image cross to the device.
        """
        c = self.canvas_size
        n = len(images_bytes) + n_pad
        if self.placement == "host":
            s = self.cfg.img_size
            pixels = np.zeros((n, s, s), np.uint8)

            def stage_one(i_data):
                i, data = i_data
                gray = (data if isinstance(data, np.ndarray)
                        else dec.safe_decode_gray(data, dummy_size=(c, c)))
                h, w = gray.shape
                pixels[i] = geo.host_resize(gray, geo.full_image_box(w, h), s)

            with ThreadPoolExecutor(min(8, max(len(images_bytes), 1))) as ex:
                list(ex.map(stage_one, enumerate(images_bytes)))
            return (pixels,)
        canvases = np.zeros((n, c, c), np.uint8)
        boxes = np.zeros((n, 4), np.int32)
        boxes[:, 2:] = 1                 # degenerate-but-valid pad boxes

        def stage_canvas(i_data):
            i, data = i_data
            gray = (data if isinstance(data, np.ndarray)
                    else dec.safe_decode_gray(data, dummy_size=(c, c)))
            h, w = min(gray.shape[0], c), min(gray.shape[1], c)
            canvases[i, :h, :w] = gray[:h, :w]
            box = geo.full_image_box(w, h)
            boxes[i] = (box.left, box.top, box.width, box.height)

        with ThreadPoolExecutor(min(8, max(len(images_bytes), 1))) as ex:
            list(ex.map(stage_canvas, enumerate(images_bytes)))
        return canvases, boxes

    def _copy(self, arrays, r: int) -> tuple:
        """Begin the host→device copy of staged host arrays on replica
        ``r``'s stream."""
        dev = self.devices[r]
        if dev.type != "cuda":
            return tuple(torch.from_numpy(a) for a in arrays)
        with self._on_stream(r):
            return tuple(torch.from_numpy(a).pin_memory().to(
                dev, non_blocking=True) for a in arrays)

    def _to_device(self, arrays):
        """Begin the host→device copy of staged host arrays: one replica's
        operand tuple, or with several replicas a list of them, replica i
        holding rows [i·n/N, (i+1)·n/N)."""
        if self.replicas == 1:
            return self._copy(arrays, 0)
        k = len(arrays[0]) // self.replicas
        return [self._copy([a[r * k:(r + 1) * k] for a in arrays], r)
                for r in range(self.replicas)]

    def _shares(self, staged) -> list:
        """The per-replica operand tuples of staged operands."""
        return staged if self.replicas > 1 else [staged]

    def _pull(self, outs: list, valid: int) -> tuple:
        """The first ``valid`` rows of the replicas' outputs (a tuple of
        tensors each), gathered on the host in replica order. Every
        replica's forward is enqueued before the first pull waits."""
        rows = len(outs[0][0])
        parts = []
        for r, out in enumerate(outs):
            n = min(rows, max(valid - r * rows, 0))
            with self._on_stream(r):
                parts.append([t[:n].cpu().numpy() for t in out])
        return tuple(np.concatenate(p) for p in zip(*parts))

    def warmup(self, with_maps: bool = False) -> None:
        """Run every bucket size once on zero operands (each on every
        replica; buckets that round to the same multiple of the replicas
        run once), so the first requests do not pay for the kernel build,
        library load and the allocator's first blocks; with ``with_maps``
        the rollout forward (which builds a quantized Predictor's dense
        trees)."""
        b, candidates = 1, []
        while b < self.batch_size:
            candidates.append(b)
            b <<= 1
        candidates.append(self.batch_size)
        for b in sorted({self._bucket(c, self.batch_size)
                         for c in candidates}):
            if self.placement == "host":
                s = self.cfg.img_size
                staged = (np.zeros((b, s, s), np.uint8),)
            else:
                boxes = np.zeros((b, 4), np.int32)
                boxes[:, 2:] = 1
                c = self.canvas_size
                staged = (np.zeros((b, c, c), np.uint8), boxes)
            if with_maps:
                self._forward_maps(self._to_device(staged), b)
            else:
                self._forward_logits(self._to_device(staged), b)

    def _bucket(self, valid: int, bs: int) -> int:
        """Smallest power-of-two batch ≥ valid, clamped to bs: log2(bs)+1
        bucket shapes in all. With several replicas it rounds up to a
        multiple of their number, so every replica gets equal rows."""
        b = 1
        while b < valid:
            b <<= 1
        n = self.replicas
        return min(max(-(-b // n) * n, n), bs)

    def stage_chunk(self, chunk: Sequence):
        """Host half of one micro-batch: decode + crop/pad/resize, pad to the
        power-of-two bucket with zero rows, and begin the host→device copy.
        Returns the staged device operands for :meth:`forward_staged`."""
        valid = len(chunk)
        if not 0 < valid <= self.batch_size:
            raise ValueError(f"chunk of {valid} images; expected 1.."
                             f"{self.batch_size}")
        return self._to_device(self._stage(
            list(chunk), self._bucket(valid, self.batch_size) - valid))

    def _logits(self, r: int, images: torch.Tensor) -> torch.Tensor:
        """Replica ``r``'s serving forward, enqueued on the current
        stream."""
        tree = self._trees[r]
        if self.tome_r:
            return tome_forward.apply_tome(
                tree, images, self.cfg, self.tome_r,
                quantized=self.quantize, schedule=self.tome_schedule,
                backend=self._backend)
        if self.quantize:
            return quantized.apply_quantized(tree, images, self.cfg,
                                             backend=self._backend)
        return vit.apply(tree, images, self.cfg)

    def _forward_logits(self, staged, valid: int) -> np.ndarray:
        """f32 logits of the first ``valid`` rows, pulled to the host (the
        pull is the synchronization point)."""
        outs = []
        for r, share in enumerate(self._shares(staged)):
            with torch.inference_mode(), self._on_stream(r):
                outs.append((self._logits(r, self._images_of(share)),))
        return self._pull(outs, valid)[0]

    def _dense_params(self, r: int = 0) -> vit.ViT:
        """Replica ``r``'s dense tree, which the attention maps run on: its
        serving tree in a dense Predictor, else one built once from
        ``params`` on its stream."""
        if not self.quantize:
            return self._trees[r]
        if self._maps_trees[r] is None:
            with self._on_stream(r):
                self._maps_trees[r] = vit.inference_params(
                    self.params, self.devices[r])
        return self._maps_trees[r]

    def _forward_maps(self, staged, valid: int):
        """(f32 logits, [valid, g, g] rollout maps) of the first ``valid``
        rows from the full-token dense forward, pulled to the host."""
        outs = []
        for r, share in enumerate(self._shares(staged)):
            params = self._dense_params(r)
            with torch.inference_mode(), self._on_stream(r):
                outs.append(attention_maps.compute_rollout(
                    params, self._images_of(share), self.cfg))
        return self._pull(outs, valid)

    def forward_staged(self, staged, valid: int,
                       with_maps: bool = False) -> PredictOutput:
        """Device half of one micro-batch: the forward on operands from
        :meth:`stage_chunk`; the sigmoid runs on the host. ``with_maps``
        runs the rollout forward and returns its logits and maps."""
        if with_maps:
            logits_np, maps_np = self._forward_maps(staged, valid)
        else:
            logits_np, maps_np = self._forward_logits(staged, valid), None
        self.forwards += 1
        # overflow-free sigmoid: exp of a non-positive argument only
        z = np.exp(-np.abs(logits_np))
        return PredictOutput(
            probs=np.where(logits_np >= 0, 1.0 / (1.0 + z), z / (1.0 + z)),
            logits=logits_np,
            classes=self.classes,
            maps=maps_np,
        )

    def predict_bytes(self, images_bytes: Sequence,
                      with_maps: bool = False) -> PredictOutput:
        """Micro-batched inference over raw encoded images."""
        bs = self.batch_size
        logits_out, probs_out, maps_out = [], [], []
        for lo in range(0, len(images_bytes), bs):
            chunk = list(images_bytes[lo:lo + bs])
            out = self.forward_staged(self.stage_chunk(chunk), len(chunk),
                                      with_maps=with_maps)
            logits_out.append(out.logits)
            probs_out.append(out.probs)
            if out.maps is not None:
                maps_out.append(out.maps)
        return PredictOutput(probs=np.concatenate(probs_out),
                             logits=np.concatenate(logits_out),
                             classes=self.classes,
                             maps=np.concatenate(maps_out) if maps_out
                             else None)

    def predict_arrays(self, grays: Sequence[np.ndarray],
                       with_maps: bool = False) -> PredictOutput:
        """Inference over already-decoded u8 grayscale arrays — same
        staging/bucketing as ``predict_bytes``, skipping the decode."""
        return self.predict_bytes([np.asarray(g, np.uint8) for g in grays],
                                  with_maps=with_maps)

    def top_findings(self, probs_row: np.ndarray, k: int = 5
                     ) -> List[Dict[str, float]]:
        order = np.argsort(probs_row)[::-1][:k]
        return [{"label": (self.classes[i] if self.classes else str(i)),
                 "probability": float(probs_row[i])} for i in order]

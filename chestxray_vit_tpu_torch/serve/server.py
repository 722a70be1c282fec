"""Minimal HTTP inference server around the port's :class:`Predictor`.

POST /predict          body: raw PNG/JPEG bytes → JSON findings
POST /predict?maps=1   → findings + "attention_map" (g × g rollout, [0, 1])
GET  /healthz          → {"status": "ok"}
GET  /metrics          → request/error counts + latency quantiles (JSON)

Stdlib only (ThreadingHTTPServer). Concurrent requests coalesce into shared
forwards through the port's ``serve.batcher.MicroBatcher``; requests with
and without maps go in separate forwards (maps always run the full-token
dense model, ``Predictor(with_maps=True)``). Serve a model that
``Trainer.save_model()`` wrote (``--model-dir``; with ``--quantize`` a
matching ``quantized/`` artifact there is loaded), or random weights from
``--seed``; dense, int8 or with token merging:

    python -m chestxray_vit_tpu_torch.serve.server --model-dir outputs/model
    python -m chestxray_vit_tpu_torch.serve.server --seed 0
    python -m chestxray_vit_tpu_torch.serve.server --seed 0 --batch-size 32 \
        --quantize static --calibration a.png b.png ...
    python -m chestxray_vit_tpu_torch.serve.server --seed 0 \
        --preset fast_serve --calibration synthetic

``--preset fast_serve`` is batch 32, static int8 and ``tome_r`` 16 under
the decreasing schedule; ``--auto-accel`` picks that stack or plain bf16
by the batch size (:func:`auto_accel_config`). Explicit flags win over a
preset, and ``--auto-accel`` refuses them, as in the JAX server.

``--data-parallel N`` serves each forward over the first N cards of this
process (``Predictor(data_parallel=N)``: one weight replica and one stream
a card, the bucket's rows split evenly and the logits gathered in card
order); the batch size must be a multiple of N:

    python -m chestxray_vit_tpu_torch.serve.server --seed 0 \
        --batch-size 32 --data-parallel 2

The CPU is one device, so ``--device cpu`` refuses N > 1. The tests hold
the replicas on ``Predictor(device=["cpu"] * N)`` and the card's smoke
run on ``["cuda:0", "cuda:0"]``, two streams on one card.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import torch

from chestxray_vit_tpu_torch.config import ModelConfig
from chestxray_vit_tpu_torch.models.vit import init_params
from chestxray_vit_tpu_torch.serve.batcher import MicroBatcher
from chestxray_vit_tpu_torch.serve.inference import Predictor

# NIH natives are 1024² PNGs (< 1 MB); anything past this is not an X-ray
MAX_BODY_BYTES = 32 * 1024 * 1024

# The accelerated serving stack as one flag: static int8 and token merging
# pay per image only when a forward carries many images, so the preset
# pins batch 32.
SERVE_PRESETS = {
    "fast_serve": {"batch_size": 32, "quantize": "static", "tome_r": 16,
                   "tome_schedule": "decreasing"},
}


class ServerStats:
    """Thread-safe request counters + a latency ring buffer for /metrics."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._lat = [0.0] * window
        self._n = 0
        self.requests = 0
        self.errors = 0
        self._t0 = time.time()

    def observe(self, seconds: float, error: bool = False) -> None:
        with self._lock:
            self.requests += 1
            self.errors += error
            self._lat[self._n % len(self._lat)] = seconds
            self._n += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat[:min(self._n, len(self._lat))])
            q = (lambda p: round(
                lat[min(int(len(lat) * p), len(lat) - 1)] * 1e3, 1)
                ) if lat else (lambda p: None)
            return {
                "requests_total": self.requests,
                "errors_total": self.errors,
                "latency_ms": {"p50": q(0.5), "p95": q(0.95),
                               "p99": q(0.99)},
                "uptime_seconds": round(time.time() - self._t0, 1),
            }


def make_handler(predictor: Predictor, max_body: int = MAX_BODY_BYTES,
                 batcher: Optional[MicroBatcher] = None,
                 stats: Optional[ServerStats] = None):
    batcher = batcher or MicroBatcher(predictor)
    stats = stats or ServerStats()

    class Handler(BaseHTTPRequestHandler):
        # socket read timeout: a stalled client can't pin a handler thread
        timeout = 60

        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/healthz" or self.path == "/":
                return self._json(200, {"status": "ok",
                                        "classes": predictor.classes})
            if self.path.rstrip("/") == "/metrics":
                return self._json(200, stats.snapshot())
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path.rstrip("/") != "/predict":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return self._json(400, {"error": "bad Content-Length"})
            if length <= 0:
                return self._json(400, {"error": "empty body"})
            if length > max_body:
                # drain a bounded amount so overshoots up to 2x the cap
                # still see the 413; never read the full declared size
                remaining = min(length, max_body)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                return self._json(413, {
                    "error": f"body exceeds {max_body} bytes"})
            data = self.rfile.read(length)
            with_maps = parse_qs(url.query).get("maps", ["0"])[-1] == "1"
            t0 = time.perf_counter()
            try:
                res = batcher.predict(data, with_maps=with_maps)
            except Exception as e:                     # noqa: BLE001
                stats.observe(time.perf_counter() - t0, error=True)
                return self._json(500, {"error": str(e)})
            stats.observe(time.perf_counter() - t0)
            payload = {"findings": predictor.top_findings(
                res.probs, k=len(res.probs))}
            if with_maps and res.attn_map is not None:
                payload["attention_map"] = res.attn_map.tolist()
            return self._json(200, payload)

    return Handler


def serve(predictor: Predictor, host: str = "127.0.0.1", port: int = 8000,
          block: bool = True) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(predictor))
    if block:
        print(f"[server] listening on http://{host}:{server.server_port}")
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def auto_accel_config(batch_size: int) -> dict:
    """The forward stack for a batch size, by the JAX server's crossover:
    static int8 with ``tome_r`` 16 under the decreasing schedule at batch
    32 and above, plain bf16 below (the stack's fewer products outweigh
    its extra launches only on large batches). Returns the Predictor
    overrides."""
    if batch_size >= 32:
        return {"quantize": "static", "tome_r": 16,
                "tome_schedule": "decreasing"}
    return {"quantize": None, "tome_r": 0, "tome_schedule": "constant"}


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    """The server's flags, with ``--auto-accel`` and ``--preset`` resolved
    into ``batch_size``, ``quantize``, ``tome_r`` and ``tome_schedule`` as
    the JAX server resolves them (explicit flags win over a preset;
    ``--auto-accel`` refuses explicit stack flags). ``calibration`` comes
    back as None, ``'synthetic'`` or the files' bytes, as ``Predictor``
    takes it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", default=None,
                    help="a Trainer.save_model() directory to serve "
                         "(Predictor.from_model_dir); without it, random "
                         "weights from --seed")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random ViT-B/16 @384 weights served "
                         "without --model-dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="images per forward (default 8, or the preset's)")
    ap.add_argument("--placement", choices=("host", "device"), default="host",
                    help="where crop/pad/resize runs (inference.Predictor)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize", nargs="?", const="dynamic",
                    choices=("dynamic", "static"), default=None,
                    help="serve the int8 forward (per-channel int8 weights, "
                         "models/quantized.py). 'dynamic' (the default when "
                         "the flag is bare): per-token activation scales; "
                         "'static': calibrated per-site scales, served "
                         "through the fused int8 kernel")
    ap.add_argument("--calibration", nargs="*", default=None,
                    help="PNG/JPEG files for --quantize static activation "
                         "calibration; 'synthetic' opts into the seeded "
                         "noise batch without the warning")
    ap.add_argument("--preset", choices=("fast_serve",), default=None,
                    help="fast_serve: batch 32 + static int8 + tome_r 16 "
                         "decreasing; explicit flags override its values")
    ap.add_argument("--auto-accel", action="store_true",
                    help="pick the stack by the batch size "
                         "(auto_accel_config: static int8 + tome_r 16 "
                         "decreasing at batch >= 32, plain bf16 below); "
                         "refuses --quantize/--tome-r/--tome-schedule/"
                         "--preset")
    ap.add_argument("--tome-r", type=int, default=None,
                    help="merge up to r token pairs per layer (token "
                         "merging: a speed/quality trade; validate it on "
                         "your data). Composes with --quantize")
    ap.add_argument("--tome-schedule", choices=("constant", "decreasing"),
                    default=None,
                    help="spread the r*L merge budget over the layers: "
                         "'decreasing' merges most in the early layers")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="shard each micro-batch over the first N devices "
                         "(0/1 = single-device; requires batch-size "
                         "divisible by N)")
    ns = ap.parse_args(argv)
    if ns.auto_accel:
        if (ns.quantize is not None or ns.tome_r is not None
                or ns.tome_schedule is not None or ns.preset):
            ap.error("--auto-accel picks the stack itself: drop "
                     "--quantize/--tome-r/--tome-schedule/--preset")
        batch = ns.batch_size if ns.batch_size is not None else 8
        vars(ns).update(auto_accel_config(batch))
        stack = (f"int8-{ns.quantize} + tome r={ns.tome_r} "
                 f"{ns.tome_schedule}" if ns.quantize else "plain bf16")
        print(f"[server] auto-accel: batch {batch} "
              f"{'>=' if batch >= 32 else '<'} 32 -> {stack}", flush=True)
    # explicit flags win over the preset, the preset over the defaults
    preset = SERVE_PRESETS.get(ns.preset, {})
    defaults = {"batch_size": 8, "quantize": None, "tome_r": 0,
                "tome_schedule": "constant"}
    for key, default in defaults.items():
        if getattr(ns, key) is None:
            setattr(ns, key, preset.get(key, default))
    if ns.calibration == ["synthetic"]:
        ns.calibration = "synthetic"
    elif ns.calibration is not None:
        if not ns.calibration:
            raise SystemExit("--calibration was given but matched no files "
                             "— pass PNG/JPEG paths or 'synthetic'")
        files = ns.calibration
        ns.calibration = []
        for path in files:
            with open(path, "rb") as f:
                ns.calibration.append(f.read())
    return ns


def main(argv: Optional[list] = None) -> int:
    ns = parse_args(argv)
    kw = dict(batch_size=ns.batch_size, placement=ns.placement,
              device=ns.device, quantize=ns.quantize,
              calibration=ns.calibration, tome_r=ns.tome_r,
              tome_schedule=ns.tome_schedule,
              data_parallel=ns.data_parallel)
    if ns.model_dir:
        predictor = Predictor.from_model_dir(ns.model_dir, **kw)
    else:
        cfg = ModelConfig()
        params = init_params(torch.Generator().manual_seed(ns.seed), cfg)
        predictor = Predictor(params, cfg, **kw)
    print("[server] warming up (building kernels, running each bucket)...",
          flush=True)
    predictor.warmup()
    serve(predictor, ns.host, ns.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

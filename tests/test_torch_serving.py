"""The port's serving slice against the JAX package's, on the CPU: the
``Predictor`` on the same weights and images, the reused ``MicroBatcher``
under concurrent submits, and the port's HTTP server."""

import fcntl
import io
import json
import subprocess
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.serve.batcher import MicroBatcher
from chestxray_vit_tpu.serve.inference import Predictor as JaxPredictor
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.serve.inference import Predictor
from chestxray_vit_tpu_torch.serve.server import serve

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CLASSES = list("ABCDE")
NATIVE_DECODE = Path(__file__).resolve().parent.parent / "native" / "decode"


def _build_native_decoder() -> None:
    """Build native/decode/libcxrdecode.so while this module is collected.

    ``chestxray_vit_tpu.data.decode`` looks for the library once per
    process and keeps the answer. Under pytest-xdist a worker that reaches
    the decoder (the Predictor here does) before it runs
    tests/test_native_decode.py, whose fixture builds the library on
    demand, keeps "not built" and skips all of that file's tests. Every
    worker collects every module before it runs any test, so building here
    settles the answer first. The Makefile's ``g++ -o`` is not atomic, so
    concurrent workers take a lock on the Makefile; where there is no
    toolchain the build fails quietly and those tests skip as before."""
    if (NATIVE_DECODE / "libcxrdecode.so").exists():
        return
    try:
        with open(NATIVE_DECODE / "Makefile") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", str(NATIVE_DECODE)],
                           capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        pass


_build_native_decoder()


def tiny_cfg(**kw):
    base = dict(img_size=32, patch_size=16, hidden_size=64, num_layers=2,
                num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                attention_impl="auto")
    base.update(kw)
    return ModelConfig(**base)


def _pair(cfg, seed=2):
    jp = jvit.init_params(jax.random.key(seed), cfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _grays(rng, n):
    # varied sizes: tall, wide, square, and one past the 64² canvas
    shapes = [(48, 64), (64, 40), (64, 64), (30, 30), (80, 70)]
    return [rng.integers(0, 256, shapes[i % len(shapes)], np.uint8)
            for i in range(n)]


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr, "L").save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("placement", ["host", "device"])
def test_predictor_matches_jax_predictor(rng, placement):
    """5 images at batch 4: one full batch and a 1-image bucket."""
    cfg = tiny_cfg()
    jp, tp = _pair(cfg)
    grays = _grays(rng, 5)
    ref = JaxPredictor(jp, cfg, classes=CLASSES, batch_size=4,
                       canvas_size=64, placement=placement
                       ).predict_arrays(grays)
    pred = Predictor(tp, cfg, classes=CLASSES, batch_size=4, canvas_size=64,
                     placement=placement, device="cpu")
    out = pred.predict_arrays(grays)
    assert out.logits.shape == (5, 5) and out.classes == CLASSES
    assert pred.forwards == 2
    # f32 on both sides; the bound of test_parity_small_vit
    np.testing.assert_allclose(out.logits, ref.logits, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.probs, ref.probs, atol=1e-5)
    top = pred.top_findings(out.probs[0], k=3)
    assert len(top) == 3 and top[0]["probability"] >= top[1]["probability"]


def test_predictor_bytes_and_buckets(rng):
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    pred = Predictor(tp, cfg, batch_size=8, canvas_size=64, device="cpu",
                     placement="device")
    assert [pred._bucket(v, 8) for v in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    staged = pred.stage_chunk([np.zeros((10, 12), np.uint8)] * 3)
    assert [tuple(t.shape) for t in staged] == [(4, 64, 64), (4, 4)]
    # tail rows are zero canvases with a degenerate-but-valid 1x1 box
    assert staged[1][3].tolist() == [0, 0, 1, 1]
    grays = _grays(rng, 3)
    a = pred.predict_bytes([_png(g) for g in grays])
    b = pred.predict_arrays(grays)
    np.testing.assert_allclose(a.logits, b.logits, atol=1e-6)
    with pytest.raises(ValueError, match="chunk"):
        pred.stage_chunk([])


def test_predictor_warmup_runs_every_bucket():
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    pred = Predictor(tp, cfg, batch_size=5, canvas_size=64, device="cpu")
    pred.warmup()                    # buckets 1, 2, 4, 5
    assert pred.forwards == 0       # warmup is not traffic


@pytest.mark.parametrize("kw", [{"quantize": "static"},
                                {"data_parallel": True}, {"tome_r": 4}])
def test_predictor_refuses_unported_options(kw):
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Predictor(tp, cfg, device="cpu", **kw)


def test_predictor_refuses_maps_and_missing_cuda(rng):
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    pred = Predictor(tp, cfg, batch_size=2, canvas_size=64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pred.predict_arrays(_grays(rng, 1), with_maps=True)
    with pytest.raises(ValueError, match="placement"):
        Predictor(tp, cfg, device="cpu", placement="gpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Predictor(tp, cfg, device="cuda")


def test_microbatcher_concurrency_matches_solo(rng):
    """Concurrent submits from several threads coalesce into fewer forwards
    than requests and give the solo results."""
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    pred = Predictor(tp, cfg, batch_size=4, canvas_size=64, device="cpu",
                     placement="device")
    grays = _grays(rng, 12)
    solo = pred.predict_arrays(grays).logits
    pred.forwards = 0
    # hold the first group's staging until every request is queued, so the
    # rest coalesce however slowly the client threads are scheduled
    all_queued = threading.Event()
    stage = pred.stage_chunk

    def gated_stage(chunk):
        all_queued.wait(timeout=30)
        return stage(chunk)

    pred.stage_chunk = gated_stage
    batcher = MicroBatcher(pred, max_wait_ms=50)
    futures = [None] * len(grays)
    try:
        def client(idx):
            for i in idx:
                futures[i] = batcher.submit(grays[i])

        threads = [threading.Thread(target=client, args=(range(t, 12, 4),))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        all_queued.set()
        results = [f.result(timeout=60) for f in futures]
    finally:
        batcher.close()
    got = np.stack([r.logits for r in results])
    np.testing.assert_allclose(got, solo, atol=1e-5)
    assert 3 <= pred.forwards <= 4      # 12 requests in batches of ≤ 4


def test_http_server_end_to_end(rng):
    cfg = tiny_cfg()
    _, tp = _pair(cfg)
    pred = Predictor(tp, cfg, classes=CLASSES, batch_size=2, canvas_size=64,
                     device="cpu")
    server = serve(pred, host="127.0.0.1", port=0, block=False)
    base = f"http://127.0.0.1:{server.server_port}"

    def post(path, data):
        req = urllib.request.Request(base + path, data=data, method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def status(path, data=None):
        try:
            req = urllib.request.Request(
                base + path, data=data,
                method="POST" if data is not None else "GET")
            urllib.request.urlopen(req, timeout=60)
        except urllib.error.HTTPError as e:
            return e.code
        return 200

    try:
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=60).read())
        assert health == {"status": "ok", "classes": CLASSES}
        gray = rng.integers(0, 256, (64, 48), np.uint8)
        out = post("/predict", _png(gray))
        assert len(out["findings"]) == 5
        probs = {f["label"]: f["probability"] for f in out["findings"]}
        ref = pred.predict_arrays([gray]).probs[0]
        np.testing.assert_allclose([probs[c] for c in CLASSES], ref,
                                   atol=1e-6)
        assert status("/nope") == 404
        assert status("/nope", b"x") == 404
        assert status("/predict", b"") == 400
        assert status("/predict?maps=1", _png(gray)) == 501
        m = json.loads(urllib.request.urlopen(base + "/metrics",
                                              timeout=60).read())
        assert m["requests_total"] == 1 and m["errors_total"] == 0
        assert m["latency_ms"]["p50"] > 0
    finally:
        server.shutdown()
        server.server_close()

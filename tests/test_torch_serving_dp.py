"""Data-parallel serving in the port against the JAX package's, on the CPU.

``Predictor(data_parallel=N)`` holds one weight replica per device and
splits each bucket's rows evenly over them. Torch has one CPU device, so
the port's replicas run on ``device=["cpu"] * N``; the JAX Predictor runs
with ``data_parallel=N`` on the conftest's virtual CPU devices. One test
here for each of tests/test_serving_dp.py's, plus each replica's rows
held bit for bit against a one-device Predictor at the replica's batch,
and the server's ``--data-parallel``."""

import numpy as np
import pytest
import torch

from chestxray_vit_tpu.serve.inference import Predictor as JaxPredictor
from chestxray_vit_tpu_torch import cli
from chestxray_vit_tpu_torch.serve import server
from chestxray_vit_tpu_torch.serve.inference import Predictor
# importing test_torch_serving also settles the native decoder's build at
# collection (see its _build_native_decoder)
from test_torch_serving import _build_native_decoder, _jax, _pair, tiny_cfg

_build_native_decoder()

# f32 on both sides: test_torch_serving's Predictor bounds
LOGIT_ATOL, LOGIT_RTOL, PROB_ATOL = 2e-5, 1e-4, 1e-5
# the port's static trees on the fused route, the JAX package's on its
# "xla" route: tests/test_torch_quant.py's ROUTE_TOL
ROUTE_TOL = 2e-2
# rollout maps, as tests/test_serving_dp.py holds them
MAP_ATOL, MAP_RTOL = 1e-5, 1e-4
CANVAS = 128


def _cfg():
    """tests/test_serving_dp.py's model: 64 px, 16 px patches (17 tokens),
    width 64, 2 layers of 4 heads, 5 classes, f32."""
    return tiny_cfg(img_size=64)


def _grays(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (96, 80), np.uint8) for _ in range(n)]


def _both(n, cfg, tp, jp, **kw):
    """The JAX Predictor over n virtual devices and the port's over n CPU
    replicas, with the same options."""
    ref = JaxPredictor(jp, _jax(cfg), canvas_size=CANVAS, data_parallel=n,
                       **kw)
    pred = Predictor(tp, cfg, canvas_size=CANVAS, device=["cpu"] * n, **kw)
    assert pred.replicas == n and ref.mesh.shape["data"] == n
    return ref, pred


def test_dp_matches_jax_and_single_device():
    cfg = _cfg()
    jp, tp = _pair(cfg)
    grays = _grays(11)                      # odd count: exercises buckets
    ref, pred = _both(8, cfg, tp, jp, batch_size=8)
    single = Predictor(tp, cfg, batch_size=8, canvas_size=CANVAS,
                       device="cpu").predict_arrays(grays)
    want, out = ref.predict_arrays(grays), pred.predict_arrays(grays)
    assert out.logits.shape == (11, 5) and pred.forwards == 2
    for other in (want, single):
        np.testing.assert_allclose(out.logits, other.logits,
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        np.testing.assert_allclose(out.probs, other.probs, atol=PROB_ATOL)


def test_dp_bucket_matches_jax():
    cfg = _cfg()
    jp, tp = _pair(cfg)
    for n, bs in ((1, 8), (2, 8), (4, 8), (8, 8), (2, 6), (4, 16),
                  (8, 16)):
        ref = JaxPredictor(jp, _jax(cfg), batch_size=bs, data_parallel=n)
        pred = Predictor(tp, cfg, batch_size=bs, device=["cpu"] * n)
        got = [pred._bucket(v, bs) for v in range(1, bs + 1)]
        assert got == [ref._bucket(v, bs) for v in range(1, bs + 1)], (n, bs)
        assert all(b % n == 0 for b in got)
    two = Predictor(tp, cfg, batch_size=8, device=["cpu"] * 2)
    assert two._bucket(1, 8) == 2 and two._bucket(3, 8) == 4
    eight = Predictor(tp, cfg, batch_size=8, device=["cpu"] * 8)
    assert [eight._bucket(v, 8) for v in (1, 5, 8)] == [8, 8, 8]


@pytest.mark.parametrize("n,buckets", [(8, [8]), (2, [2, 4, 8])])
def test_dp_warmup_runs_each_collapsed_bucket_once(n, buckets):
    """warmup runs each distinct bucket once on every replica (at batch 8
    over 8 replicas the buckets 1, 2, 4, 8 collapse to one), is not
    counted as traffic, and the Predictor then answers as JAX's does."""
    cfg = _cfg()
    jp, tp = _pair(cfg)
    ref, pred = _both(n, cfg, tp, jp, batch_size=8)
    seen = []
    logits = pred._logits
    pred._logits = lambda r, x: seen.append((r, len(x))) or logits(r, x)
    pred.warmup()
    ref.warmup()
    assert seen == [(r, b // n) for b in buckets for r in range(n)]
    assert pred.forwards == 0
    grays = _grays(3)
    out = pred.predict_arrays(grays)
    assert out.probs.shape == (3, 5)
    np.testing.assert_allclose(out.logits, ref.predict_arrays(grays).logits,
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_dp_with_static_quantize():
    """Calibrated once on replica 0, every replica serves the same int8
    tree; against the JAX static data-parallel Predictor."""
    cfg = _cfg()
    jp, tp = _pair(cfg)
    grays = _grays(6, seed=3)
    ref, pred = _both(8, cfg, tp, jp, batch_size=8, quantize="static",
                      calibration="synthetic")
    for tree in pred._trees[1:]:
        for (name, a), (_, b) in zip(pred._trees[0].named_buffers(),
                                     tree.named_buffers()):
            assert torch.equal(a, b), name
    out, want = pred.predict_arrays(grays), ref.predict_arrays(grays)
    np.testing.assert_allclose(out.logits, want.logits, atol=ROUTE_TOL)
    assert np.abs(out.probs - want.probs).max() < 0.1   # the JAX test's


def test_dp_device_placement():
    cfg = _cfg()
    jp, tp = _pair(cfg)
    grays = _grays(4, seed=5)
    ref, pred = _both(4, cfg, tp, jp, batch_size=4, placement="device")
    staged = pred.stage_chunk(grays[:3])     # bucket 4: one row a replica
    assert [[tuple(t.shape) for t in share] for share in staged] == \
        [[(1, CANVAS, CANVAS), (1, 4)]] * 4
    assert staged[3][1][0].tolist() == [0, 0, 1, 1]   # the pad row's box
    out, want = pred.predict_arrays(grays), ref.predict_arrays(grays)
    np.testing.assert_allclose(out.probs, want.probs, atol=PROB_ATOL)
    np.testing.assert_allclose(out.logits, want.logits, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)


def test_dp_rollout_maps():
    cfg = _cfg()
    jp, tp = _pair(cfg)
    grays = _grays(4, seed=7)
    ref, pred = _both(4, cfg, tp, jp, batch_size=4)
    out = pred.predict_arrays(grays, with_maps=True)
    want = ref.predict_arrays(grays, with_maps=True)
    assert out.maps.shape == want.maps.shape == (4, 4, 4)
    np.testing.assert_allclose(out.maps, want.maps, atol=MAP_ATOL,
                               rtol=MAP_RTOL)
    np.testing.assert_allclose(out.logits, want.logits, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)


@pytest.mark.parametrize("match,jax_kw,kw", [
    ("must be >= 1", dict(data_parallel=-1),
     dict(data_parallel=-1, device="cpu")),
    # the CPU is one device to torch
    ("devices", dict(batch_size=64, data_parallel=9),
     dict(batch_size=64, data_parallel=2, device="cpu")),
    ("devices", None, dict(data_parallel=3, device=["cpu"] * 2)),
    ("divisible", dict(batch_size=6, data_parallel=4),
     dict(batch_size=6, device=["cpu"] * 4)),
])
def test_dp_validation_errors(match, jax_kw, kw):
    """The JAX Predictor's refusals, in its words."""
    cfg = _cfg()
    jp, tp = _pair(cfg)
    if jax_kw is not None:
        with pytest.raises(ValueError, match=match):
            JaxPredictor(jp, _jax(cfg), **jax_kw)
    with pytest.raises(ValueError, match=match):
        Predictor(tp, cfg, **kw)


def test_dp_composes_with_tome_and_quantize():
    """Static int8 + tome_r 2 over 4 replicas: against the JAX Predictor's
    data-parallel stack, and the port's one-device stack at the JAX test's
    bound."""
    cfg = _cfg()
    jp, tp = _pair(cfg)
    grays = _grays(8, seed=3)
    kw = dict(batch_size=8, quantize="static", calibration="synthetic",
              tome_r=2)
    ref, pred = _both(4, cfg, tp, jp, **kw)
    single = Predictor(tp, cfg, canvas_size=CANVAS, device="cpu", **kw)
    out = pred.predict_arrays(grays)
    np.testing.assert_allclose(out.logits, ref.predict_arrays(grays).logits,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(out.logits,
                               single.predict_arrays(grays).logits,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [
    {}, {"placement": "device"}, {"quantize": "dynamic"},
    {"quantize": "static"}, {"tome_r": 2, "tome_schedule": "decreasing"},
    {"quantize": "static", "tome_r": 2}, {"with_maps": True}],
    ids=["dense", "device", "dynamic", "static", "tome", "static_tome",
         "maps"])
def test_dp_replica_rows_equal_one_device_bit_for_bit(kw):
    """Replica i's rows of a batch of 8 over 2 replicas are, bit for bit,
    what a one-device Predictor at batch 4 gives on those 4 rows: every
    product and kernel sees the same shapes."""
    cfg = _cfg()
    _, tp = _pair(cfg)
    kw = dict(kw)
    maps = kw.pop("with_maps", False)
    if kw.get("quantize") == "static":
        kw["calibration"] = "synthetic"
    grays = _grays(8, seed=11)
    pred = Predictor(tp, cfg, batch_size=8, canvas_size=CANVAS,
                     device=["cpu"] * 2, **kw)
    one = Predictor(tp, cfg, batch_size=4, canvas_size=CANVAS,
                    device="cpu", **kw)
    out = pred.predict_arrays(grays, with_maps=maps)
    for r in range(2):
        want = one.predict_arrays(grays[4 * r:4 * r + 4], with_maps=maps)
        assert np.array_equal(out.logits[4 * r:4 * r + 4], want.logits)
        if maps:
            assert np.array_equal(out.maps[4 * r:4 * r + 4], want.maps)


class _Stub:
    def warmup(self):
        pass


def test_server_data_parallel_flag(monkeypatch):
    """``--data-parallel N`` reaches ``Predictor.from_model_dir`` from the
    server and from the CLI's ``serve``; without the flag it is 0."""
    seen = []
    monkeypatch.setattr(server.Predictor, "from_model_dir",
                        lambda directory, **kw: seen.append(kw) or _Stub())
    monkeypatch.setattr(server, "serve", lambda *a, **k: None)
    argv = ["--model-dir", "m", "--device", "cpu", "--batch-size", "4"]
    assert server.main(argv + ["--data-parallel", "2"]) == 0
    assert cli.main(["serve", *argv, "--data-parallel", "4"]) == 0
    assert server.main(argv) == 0
    assert [kw["data_parallel"] for kw in seen] == [2, 4, 0]
    assert server.parse_args([]).data_parallel == 0


def test_cpu_server_refuses_data_parallel(monkeypatch):
    """A CPU server asked for two devices refuses with the JAX message."""
    monkeypatch.setattr(server, "ModelConfig", _cfg)
    monkeypatch.setattr(server, "serve", lambda *a, **k: None)
    with pytest.raises(ValueError, match="2 > 1 devices"):
        server.main(["--device", "cpu", "--data-parallel", "2"])

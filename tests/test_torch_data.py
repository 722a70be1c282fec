"""The port's host data layer, logging and host metrics against the JAX
package's, on the same inputs: storage (memory, local, and GCS through the
in-process emulator), metadata parsing and splits, the crop geometry on
seeded generators, the fake NIH bucket byte for byte, ``iterate_batches``
array for array (shuffled, augmented, skipped, padded, both placements),
``DevicePrefetcher`` on the CPU, tfevents both ways, ``MetricLogger``,
``utils/flops`` and the host half of ``eval/metrics``."""

import dataclasses
import io
import os
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu.data import geometry as jgeo
from chestxray_vit_tpu.data import metadata as jmd
from chestxray_vit_tpu.data import pipeline as jpipe
from chestxray_vit_tpu.data import storage as jstorage
from chestxray_vit_tpu.data import testing as jtesting
from chestxray_vit_tpu.eval import metrics as jmetrics
from chestxray_vit_tpu.utils import flops as jflops
from chestxray_vit_tpu.utils import logging as jlogging
from chestxray_vit_tpu.utils import tfevents as jtfevents
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.data import geometry as tgeo
from chestxray_vit_tpu_torch.data import metadata as tmd
from chestxray_vit_tpu_torch.data import pipeline as tpipe
from chestxray_vit_tpu_torch.data import storage as tstorage
from chestxray_vit_tpu_torch.data import testing as ttesting
from chestxray_vit_tpu_torch.eval import metrics as tmetrics
from chestxray_vit_tpu_torch.utils import flops as tflops
from chestxray_vit_tpu_torch.utils import logging as tlogging
from chestxray_vit_tpu_torch.utils import tfevents as ttfevents

FAKE = dict(num_images=40, image_size=64, seed=3)


@pytest.fixture(scope="module")
def fakes():
    return (jtesting.build_fake_nih(**FAKE), ttesting.build_fake_nih(**FAKE))


def _data_cfgs(**kw):
    return (jconfig.DataConfig(backend="memory", **kw),
            tconfig.DataConfig(backend="memory", **kw))


# ---------------------------------------------------------------------------
# fake bucket, storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [FAKE, dict(num_images=30, image_size=96,
                                           seed=17, bbox_fraction=0.5)])
def test_fake_nih_blobs_equal_jax_byte_for_byte(kw):
    j, t = jtesting.build_fake_nih(**kw), ttesting.build_fake_nih(**kw)
    assert sorted(t.store._blobs) == sorted(j.store._blobs)
    assert all(t.store.get(n) == j.store.get(n) for n in j.store._blobs)
    assert (t.image_names, t.labels_by_name, t.bboxes_by_name) == \
        (j.image_names, j.labels_by_name, j.bboxes_by_name)


def test_render_array_dataset_equals_jax():
    ji, jl = jtesting.render_array_dataset(24, 64, seed=5)
    ti, tl = ttesting.render_array_dataset(24, 64, seed=5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


def test_local_and_memory_stores_match_jax(fakes, tmp_path):
    for name, data in fakes[0].store._blobs.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    jcfg, tcfg = _data_cfgs()
    jcfg.backend = tcfg.backend = "local"
    jcfg.local_root = tcfg.local_root = str(tmp_path)
    jl, tl = jstorage.open_store(jcfg), tstorage.open_store(tcfg)
    assert isinstance(tl, tstorage.LocalStore)
    for prefix in ("images_001/images/", "images_0", "Data_"):
        assert tl.list(prefix) == jl.list(prefix)
    assert tl.get("test_list.txt") == jl.get("test_list.txt")
    assert tl.exists("BBox_List_2017.csv") and not tl.exists("nope")
    assert tstorage.build_blob_map(tl, tcfg) == \
        jstorage.build_blob_map(jl, jcfg)
    mem_j, mem_t = fakes[0].store, fakes[1].store
    assert tstorage.build_blob_map(mem_t, tcfg) == \
        jstorage.build_blob_map(mem_j, jcfg)
    with pytest.raises(ValueError, match="MemoryStore"):
        tstorage.open_store(tconfig.DataConfig(backend="memory"))
    with pytest.raises(ValueError, match="unknown storage backend"):
        tstorage.open_store(tconfig.DataConfig(backend="ftp"))


def test_retrying_store_retries_transient_and_not_missing():
    calls = []

    class Flaky:
        def get(self, name):
            calls.append(name)
            if len(calls) < 3:
                raise ConnectionError("blip")
            return b"ok"

        def list(self, prefix):
            raise KeyError(prefix)

        def exists(self, name):
            return True

    store = tstorage.RetryingStore(Flaky(), retries=3, base_delay=0.0)
    with redirect_stdout(io.StringIO()):
        assert store.get("x") == b"ok"
    assert len(calls) == 3
    with pytest.raises(KeyError):             # permanent: no retry
        store.list("p")


def test_gcs_store_against_the_emulator(fakes):
    pytest.importorskip("google.cloud.storage")
    from tests.gcs_emulator import start_emulator

    bucket = "cxr-fake"
    em = start_emulator({bucket: dict(fakes[0].store._blobs)})
    old = os.environ.get("STORAGE_EMULATOR_HOST")
    os.environ["STORAGE_EMULATOR_HOST"] = em.url
    try:
        jcfg, tcfg = _data_cfgs()
        for c in (jcfg, tcfg):
            c.backend, c.gcs_bucket_name = "gcs", bucket
        js, ts = jstorage.open_store(jcfg), tstorage.open_store(tcfg)
        assert isinstance(ts, tstorage.RetryingStore)
        assert isinstance(ts.inner, tstorage.GCSStore)
        name = "images_001/images/00000000_000.png"
        assert ts.get(name) == js.get(name) == fakes[0].store.get(name)
        assert ts.list("images_002/") == js.list("images_002/")
        assert ts.exists(name) and not ts.exists("images_001/none.png")
        assert tstorage.build_blob_map(ts, tcfg) == \
            jstorage.build_blob_map(js, jcfg)
        jb = jpipe.build_datasets(jcfg, js)
        tb = tpipe.build_datasets(tcfg, ts)
        assert tb.train.filenames == jb.train.filenames
    finally:
        if old is None:
            os.environ.pop("STORAGE_EMULATOR_HOST", None)
        else:
            os.environ["STORAGE_EMULATOR_HOST"] = old
        em.stop()


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

def test_csv_parsing_matches_jax(fakes):
    text = fakes[0].store.get("Data_Entry_2017.csv").decode()
    text += "\nextra.png, Mass | No Finding |Edema ,0,0\nblank.png,,1,1"
    je, jv = jmd.parse_data_entry_csv(text)
    te, tv = tmd.parse_data_entry_csv(text)
    assert tv == jv
    assert [dataclasses.asdict(e) for e in te] == \
        [dataclasses.asdict(e) for e in je]
    bb = fakes[0].store.get("BBox_List_2017.csv").decode()
    jb, tb = jmd.parse_bbox_csv(bb), tmd.parse_bbox_csv(bb)
    assert {k: [dataclasses.astuple(b) for b in v] for k, v in tb.items()} \
        == {k: [dataclasses.astuple(b) for b in v] for k, v in jb.items()}
    for bad in ("", "Image Index\n"):
        with pytest.raises(ValueError) as jerr:
            jmd.parse_data_entry_csv(bad)
        with pytest.raises(ValueError) as terr:
            tmd.parse_data_entry_csv(bad)
        assert str(terr.value) == str(jerr.value)
    lb_j, lb_t = jmd.LabelBinarizer(jv), tmd.LabelBinarizer(tv)
    lists = [["Mass", "Edema"], ["Unknown"], []]
    np.testing.assert_array_equal(lb_t.transform(lists),
                                  lb_j.transform(lists))
    assert lb_t.inverse_transform(lb_t.transform(lists)) == \
        lb_j.inverse_transform(lb_j.transform(lists))


@pytest.mark.parametrize("n,seed", [(97, 42), (1000, 7)])
def test_splits_match_jax(n, seed):
    items = [f"{i:05d}.png" for i in range(n)]
    assert tmd.train_test_split(items, 0.15, seed) == \
        jmd.train_test_split(items, 0.15, seed)
    assert tmd.datasets_train_test_split(items, 0.2, seed) == \
        jmd.datasets_train_test_split(items, 0.2, seed)
    assert tmd.split_80_10_10(items, seed) == jmd.split_80_10_10(items, seed)


@pytest.mark.parametrize("scheme,subset", [("official_lists", None),
                                           ("random_80_10_10", 12)])
def test_build_datasets_matches_jax(fakes, scheme, subset):
    jcfg, tcfg = _data_cfgs(split_scheme=scheme, use_subset_data=subset)
    jb = jpipe.build_datasets(jcfg, fakes[0].store)
    tb = tpipe.build_datasets(tcfg, fakes[1].store)
    assert tb.classes == jb.classes and tb.blob_map == jb.blob_map
    for split in ("train", "val", "test"):
        j, t = getattr(jb, split), getattr(tb, split)
        assert t.filenames == j.filenames and t.classes == j.classes
        np.testing.assert_array_equal(t.labels, j.labels)
        assert {k: [dataclasses.astuple(b) for b in v]
                for k, v in t.bboxes.items()} == \
            {k: [dataclasses.astuple(b) for b in v]
             for k, v in j.bboxes.items()}


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_crop_geometry_matches_jax():
    shapes = [(64, 64), (512, 384), (33, 1000), (1000, 33), (7, 9)]
    for seed in range(8):
        for w, h in shapes:
            rj = np.random.default_rng((seed, w, h))
            rt = np.random.default_rng((seed, w, h))
            assert dataclasses.astuple(tgeo.sample_random_resized_crop(
                rt, w, h)) == dataclasses.astuple(
                jgeo.sample_random_resized_crop(rj, w, h))
    boxes = [(10.7, 5.2, 30.0, 20.0), (-5, -5, 20, 20), (60, 60, 30, 30),
             (0, 0, 0, 10), (70, 10, 5, 5)]
    for x, y, bw, bh in boxes:
        jb, tb = (jmd.BBox("Mass", x, y, bw, bh),
                  tgeo.BBox("Mass", x, y, bw, bh))
        jc, tc = jgeo.clamp_bbox(jb, 64, 64), tgeo.clamp_bbox(tb, 64, 64)
        assert (tc is None) == (jc is None)
        if jc is not None:
            assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
        assert dataclasses.astuple(tgeo.select_crop(tb, 64, 48)) == \
            dataclasses.astuple(jgeo.select_crop(jb, 64, 48))
    assert dataclasses.astuple(tgeo.select_crop(None, 50, 40)) == \
        dataclasses.astuple(jgeo.select_crop(None, 50, 40))


# ---------------------------------------------------------------------------
# loader and batches
# ---------------------------------------------------------------------------

def _loaders(fakes, placement="host", augment=True, split="train"):
    jcfg, tcfg = _data_cfgs()
    jb = jpipe.build_datasets(jcfg, fakes[0].store)
    tb = tpipe.build_datasets(tcfg, fakes[1].store)
    kw = dict(img_size=32, placement=placement, canvas_size=96,
              augment=augment)
    return (jpipe.SampleLoader(getattr(jb, split), jb.blob_map, jb.store,
                               **kw),
            tpipe.SampleLoader(getattr(tb, split), tb.blob_map, tb.store,
                               **kw))


def _assert_batches_equal(tb, jb):
    assert len(tb) == len(jb) and len(tb) > 0
    for t, j in zip(tb, jb):
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("placement,augment,kw", [
    ("host", True, dict(epoch=1, shuffle=True, drop_last=True)),
    ("host", True, dict(epoch=2, shuffle=True, drop_last=True,
                        skip_batches=2)),
    ("host", False, dict(pad_last=True)),
    ("device", True, dict(epoch=0, shuffle=True, skip_batches=1)),
    ("device", False, dict(pad_last=True, batch_size=7)),
], ids=["shuffled_augmented", "skip_batches", "pad_last", "device",
        "device_pad_last"])
def test_iterate_batches_matches_jax_array_for_array(fakes, placement,
                                                     augment, kw):
    jl, tl = _loaders(fakes, placement, augment,
                      "val" if kw.get("pad_last") else "train")
    kw = {"batch_size": 5, "seed": 11, "num_workers": 3,
          "prefetch_batches": 2, **kw}
    bs = kw.pop("batch_size")
    _assert_batches_equal(list(tpipe.iterate_batches(tl, bs, **kw)),
                          list(jpipe.iterate_batches(jl, bs, **kw)))


def test_skip_batches_resumes_the_same_stream(fakes):
    """A resumed epoch's batches are the tail of the uninterrupted one,
    augmentation included."""
    _, tl = _loaders(fakes)
    kw = dict(epoch=3, shuffle=True, seed=5, drop_last=True, num_workers=2)
    full = list(tpipe.iterate_batches(tl, 4, **kw))
    tail = list(tpipe.iterate_batches(tl, 4, skip_batches=3, **kw))
    _assert_batches_equal(tail, full[3:])
    assert tpipe.epoch_order(10, 2, 5, True).tolist() == \
        jpipe.epoch_order(10, 2, 5, True).tolist()


def test_device_prefetcher_on_cpu(fakes):
    _, tl = _loaders(fakes)
    kw = dict(epoch=0, shuffle=True, seed=1, drop_last=True, num_workers=2)
    want = list(tpipe.iterate_batches(tl, 4, **kw))
    got = list(tpipe.DevicePrefetcher(tpipe.iterate_batches(tl, 4, **kw),
                                      "cpu", depth=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    # abandoned early: close() releases the producer and the pools
    pf = tpipe.DevicePrefetcher(tpipe.iterate_batches(tl, 4, **kw), "cpu",
                                depth=1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()

    def failing():
        yield want[0]
        raise OSError("disk gone")

    pf = tpipe.DevicePrefetcher(failing(), "cpu")
    next(pf)
    with pytest.raises(OSError, match="disk gone"):
        next(pf)


# ---------------------------------------------------------------------------
# logging, tfevents, flops
# ---------------------------------------------------------------------------

def test_tfevents_round_trip_both_ways(tmp_path):
    points = [("train/loss", 0.6931, 1), ("train/lr", 1e-4, 1),
              ("eval/avg_auroc", float("nan"), 2), ("train/loss", -3.5, 10**9)]
    for writer, reader, sub in ((ttfevents.EventWriter,
                                 jtfevents.read_scalars, "t"),
                                (jtfevents.EventWriter,
                                 ttfevents.read_scalars, "j")):
        w = writer(str(tmp_path / sub))
        for tag, v, s in points:
            w.add_scalar(tag, v, s)
        w.close()
        (path,) = (tmp_path / sub).iterdir()
        got = reader(str(path))
        assert [(s, t) for s, t, _ in got] == [(s, t) for t, _, s in points]
        np.testing.assert_array_equal(
            [v for _, _, v in got],
            np.float32([v for _, v, _ in points]))
    assert ttfevents._masked_crc(b"cxr") == jtfevents._masked_crc(b"cxr")


def test_metric_logger_output_matches_jax(tmp_path):
    outs = {}
    for name, mod in (("j", jlogging), ("t", tlogging)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            lg = mod.MetricLogger(str(tmp_path / name), "tensorboard")
            lg.log(1, {"loss": 0.5, "lr": np.float32(1e-4)},
                   progress="1/10 (10.0%, eta ?)")
            lg.log(2, {"avg_auroc": 0.75}, "eval")
            lg.save_results("train", {"train_runtime": 1.5})
            lg.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            jsonl = f.read()
        with open(tmp_path / name / "train_results.json") as f:
            results = f.read()
        (tb,) = (tmp_path / name / "tb").iterdir()
        outs[name] = (buf.getvalue(), jsonl, results,
                      jtfevents.read_scalars(str(tb)))
    assert outs["t"] == outs["j"]


def test_throughput_meter_matches_jax(monkeypatch):
    clock = iter([0.0, 1.0, 2.0, 2.5, 13.0, 14.0])
    times = list(clock)
    rates = {}
    for name, mod in (("j", jlogging), ("t", tlogging)):
        seq = iter(times)
        monkeypatch.setattr(time, "perf_counter", lambda: next(seq))
        m = mod.ThroughputMeter(window=2)
        got = []
        for i in range(len(times)):
            if i == 3:
                m.reset()
            m.step(8)
            got.append(m.images_per_sec)
        rates[name] = got
    assert rates["t"] == rates["j"] and max(rates["t"]) > 0


@pytest.mark.parametrize("model", [
    {}, {"img_size": 512, "num_classes": 14},
    {"hidden_size": 1024, "num_layers": 24, "num_heads": 16,
     "mlp_dim": 4096}], ids=["vit_b16", "vit_b16_512", "vit_l16"])
def test_flops_match_jax(model):
    jm, tm = jconfig.ModelConfig(**model), tconfig.ModelConfig(**model)
    for fwd_only in (False, True):
        assert tflops.model_flops_per_image(tm, fwd_only) == \
            jflops.model_flops_per_image(jm, fwd_only)
        for s in (577, 1152):
            assert tflops.packed_flops_per_sequence(tm, s, fwd_only) == \
                jflops.packed_flops_per_sequence(jm, s, fwd_only)
    for kind in ("TPU v5 lite", "TPU v5e", "TPU v6e", "TPU v5p",
                 "TPU v4", "TPU v3", "something else"):
        assert tflops.chip_peak_flops(kind) == jflops.chip_peak_flops(kind)
        assert tflops.mfu(100.0, tm, kind) == jflops.mfu(100.0, jm, kind)
    assert tflops.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12


# ---------------------------------------------------------------------------
# host metrics
# ---------------------------------------------------------------------------

def _logits_labels(seed=0, n=64, c=6):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, c)) < 0.3).astype(np.float32)
    labels[:, -1] = 0                         # a degenerate class
    logits = (rng.normal(size=(n, c)) + 1.5 * labels).astype(np.float32)
    logits[:4, 0] = 40.0                      # saturated sigmoid ties
    return logits, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_host_metrics_match_jax(seed, tmp_path):
    logits, labels = _logits_labels(seed)
    names = [f"class_{i}" for i in range(logits.shape[1])]
    th_j = jmetrics.calibrate_thresholds(logits, labels)
    th_t = tmetrics.calibrate_thresholds(logits, labels)
    np.testing.assert_array_equal(th_t, th_j)
    for th in (0.5, th_t):
        assert tmetrics.classification_report(logits, labels, names, th) \
            == jmetrics.classification_report(logits, labels, names, th)
        assert tmetrics.f1_micro_at(logits, labels, th) == \
            jmetrics.f1_micro_at(logits, labels, th)
    text = tmetrics.write_classification_report(
        str(tmp_path / "r.txt"), logits, labels.astype(np.int64), names,
        th_t)
    assert text == jmetrics.write_classification_report(
        str(tmp_path / "j.txt"), logits, labels.astype(np.int64), names,
        th_t)
    assert (tmp_path / "r.txt").read_text() == text
    # compute_metrics on numpy arrays, as the trainer passes them
    got = tmetrics.compute_metrics(logits, labels, names)
    want = jmetrics.compute_metrics(logits, labels, names)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                   equal_nan=True, err_msg=k)

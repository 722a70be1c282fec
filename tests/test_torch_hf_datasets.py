"""The port's HF-datasets adapter (``data/hf_datasets.py``) against the
JAX package's, on an in-memory ``datasets.Dataset`` (no hub access):
samples array for array under the same numpy rng, the split and the class
names equal, the adapters through ``iterate_batches`` and the port's
Trainer, and the Trainer's ``hf_dataset`` backend reaching
``load_hf_dataset``."""

import numpy as np
import pytest
import torch

datasets = pytest.importorskip("datasets")

from PIL import Image  # noqa: E402

from chestxray_vit_tpu.data import hf_datasets as jhf  # noqa: E402
from chestxray_vit_tpu.data import pipeline as jpipe  # noqa: E402
from chestxray_vit_tpu_torch import config as tconfig  # noqa: E402
from chestxray_vit_tpu_torch.data import hf_datasets as thf  # noqa: E402
from chestxray_vit_tpu_torch.data import pipeline as tpipe  # noqa: E402

CLASSES = ["Atelectasis", "Cardiomegaly", "Effusion", "No Finding"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_ds():
    rng = np.random.default_rng(0)
    shapes = [(48, 64), (64, 40), (50, 50)]
    images = [Image.fromarray(rng.integers(0, 255, shapes[i % 3], np.uint8),
                              "L") for i in range(30)]
    labels = [sorted({int(rng.integers(0, 4)) for _ in range(2)})
              for _ in range(30)]
    feats = datasets.Features({
        "image": datasets.Image(),
        "labels": datasets.Sequence(datasets.ClassLabel(names=CLASSES)),
    })
    return datasets.Dataset.from_dict(
        {"image": images, "labels": labels}, features=feats)


def test_class_names_and_split_match_jax(hf_ds):
    assert thf.class_names_of(hf_ds) == jhf.class_names_of(hf_ds) == CLASSES
    for seed in (42, 7):
        got = thf.split_hf_dataset(hf_ds, seed=seed)
        want = jhf.split_hf_dataset(hf_ds, seed=seed)
        assert [len(s) for s in got] == [24, 3, 3]
        for g, w in zip(got, want):
            assert g["labels"] == w["labels"]
            assert [np.asarray(i).tobytes() for i in g["image"]] == \
                [np.asarray(i).tobytes() for i in w["image"]]


@pytest.mark.parametrize("augment", [False, True])
def test_adapter_samples_match_jax(hf_ds, augment):
    tad = thf.HFDatasetAdapter(hf_ds, CLASSES, img_size=32, augment=augment)
    jad = jhf.HFDatasetAdapter(hf_ds, CLASSES, img_size=32, augment=augment)
    trng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    assert len(tad) == len(jad) == 30
    for i in range(len(hf_ds)):
        got, want = tad.load(i, trng), jad.load(i, jrng)
        assert got["pixel_values_u8"].shape == (32, 32)
        np.testing.assert_array_equal(got["pixel_values_u8"],
                                      want["pixel_values_u8"])
        np.testing.assert_array_equal(got["labels"], want["labels"])


@pytest.mark.parametrize("labels", [["Cardiomegaly", "Effusion"], [1, 0, 1, 0],
                                    [0, 2], 3],
                         ids=["names", "multi_hot", "indices", "int"])
def test_label_forms_match_jax(labels):
    row = {"image": Image.fromarray(np.zeros((32, 32), np.uint8), "L"),
           "labels": labels}
    got = thf.HFDatasetAdapter([row], CLASSES, img_size=16).load(0)
    want = jhf.HFDatasetAdapter([row], CLASSES, img_size=16).load(0)
    np.testing.assert_array_equal(got["labels"], want["labels"])


def test_resize_center_crop_matches_jax():
    rng = np.random.default_rng(2)
    for shape in [(40, 80), (80, 40), (33, 33), (70, 45)]:
        gray = rng.integers(0, 255, shape, np.uint8)
        np.testing.assert_array_equal(thf._resize_center_crop(gray, 32),
                                      jhf._resize_center_crop(gray, 32))


def test_adapter_batches_match_jax(hf_ds):
    tad = thf.HFDatasetAdapter(hf_ds, CLASSES, img_size=32, augment=True)
    jad = jhf.HFDatasetAdapter(hf_ds, CLASSES, img_size=32, augment=True)
    got = list(tpipe.iterate_batches(tad, 8, epoch=1, shuffle=True,
                                     drop_last=True, num_workers=2))
    want = list(jpipe.iterate_batches(jad, 8, epoch=1, shuffle=True,
                                      drop_last=True, num_workers=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_trainer_with_hf_adapters(tmp_path, hf_ds, monkeypatch):
    """The ``hf_dataset`` backend: the Trainer calls ``load_hf_dataset``
    (here returning adapters over the in-memory dataset, as the hub's
    dataset would be split) and trains and evaluates on them."""
    from chestxray_vit_tpu_torch.train.trainer import Trainer

    calls = []

    def load(name, img_size=384, augment_train=True):
        calls.append((name, img_size, augment_train))
        tr, va, te = thf.split_hf_dataset(hf_ds)
        mk = lambda split, aug: thf.HFDatasetAdapter(
            split, CLASSES, img_size=img_size, augment=aug)
        return mk(tr, augment_train), mk(va, False), mk(te, False), CLASSES

    monkeypatch.setattr(thf, "load_hf_dataset", load)
    cfg = tconfig.Config(
        data=tconfig.DataConfig(backend="hf_dataset", augment=True,
                                hf_dataset_name="org/xrays"),
        model=tconfig.ModelConfig(img_size=32, patch_size=16, hidden_size=64,
                                  num_layers=2, num_heads=1, mlp_dim=128,
                                  dtype="float32"),
        train=tconfig.TrainConfig(batch_size_per_core=2, max_steps=3,
                                  eval_strategy="no", save_strategy="no",
                                  load_best_model_at_end=False,
                                  logging_steps=1, report_to="none",
                                  output_dir=str(tmp_path / "out")))
    trainer = Trainer(cfg, pretrained=False, device="cpu")
    assert calls == [("org/xrays", 32, True)]
    assert cfg.model.num_classes == 4 and trainer.bundle.classes == CLASSES
    trainer.train()
    assert int(trainer.state.step) == 3
    ev = trainer.evaluate()
    assert np.isfinite(ev["eval_loss"]) and "f1_micro" in ev
    trainer.close()

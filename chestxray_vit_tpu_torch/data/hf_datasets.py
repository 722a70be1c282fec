"""HF-datasets adapter of the port (the reference's Version A data path),
a copy of ``chestxray_vit_tpu/data/hf_datasets.py``.

The reference's Version A loads a prepackaged HF dataset
(``load_dataset('kerem/nih-chest-xray-14')``) behind a master-gated
download barrier, splits it 80/10/10 with seed 42, reads the class names
from the dataset features and applies torchvision train / eval transforms.

``HFDatasetAdapter`` maps any HF image-classification dataset with
``image`` + ``labels`` columns onto the loader protocol: samples come out
as the ``{'pixel_values_u8', 'labels'}`` dicts the native pipeline makes,
so the Trainer's loops work unchanged. :func:`load_hf_dataset` owns the
barrier, over the port's ``parallel/distributed.py`` (a no-op in one
process): the primary downloads, the rest wait, then load from the warm
cache. ``datasets`` is imported only there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np

from chestxray_vit_tpu_torch.data import geometry as geo
from chestxray_vit_tpu_torch.data.geometry import host_resize
from chestxray_vit_tpu_torch.data.metadata import LabelBinarizer


@dataclass
class HFDatasetAdapter:
    """Duck-typed stand-in for (DatasetIndex + SampleLoader) over an HF
    dataset split. Satisfies everything ``iterate_batches`` needs:
    ``.index`` (sized), ``.augment``, and ``.load(i, rng)``."""

    dataset: Any                      # datasets.Dataset (image split)
    classes: List[str]
    img_size: int = 384
    augment: bool = False             # RandomResizedCrop + HFlip (train)
    image_column: str = "image"
    label_column: str = "labels"

    def __post_init__(self):
        self._binarizer = LabelBinarizer(self.classes)
        self.index = self            # self-sized index

    def __len__(self) -> int:
        return len(self.dataset)

    # -- label handling ----------------------------------------------------

    def _labels_of(self, row) -> np.ndarray:
        raw = row[self.label_column]
        if isinstance(raw, (list, tuple, np.ndarray)):
            if len(raw) and isinstance(raw[0], str):
                return self._binarizer.transform([list(raw)])[0].astype(
                    np.float32)
            arr = np.asarray(raw)
            if (arr.size == len(self.classes) and arr.size > 1
                    and np.isin(arr, (0, 1)).all()):
                # a length-num_classes 0/1 vector is a multi-hot row (the
                # standard multilabel encoding), NOT a list of class
                # indices — treating [1,0,1,...] as indices would light
                # out[0]/out[1] for every sample and train on garbage
                return arr.astype(np.float32)
            out = np.zeros(len(self.classes), np.float32)
            for idx in raw:
                out[int(idx)] = 1.0
            return out
        out = np.zeros(len(self.classes), np.float32)
        out[int(raw)] = 1.0
        return out

    # -- sample loading ----------------------------------------------------

    def load(self, i: int, rng: Optional[np.random.Generator] = None):
        row = self.dataset[int(i)]
        img = row[self.image_column]
        try:
            gray = np.asarray(img.convert("L"), dtype=np.uint8) \
                if hasattr(img, "convert") else np.asarray(img,
                                                           dtype=np.uint8)
        except Exception as e:                           # noqa: BLE001
            # dummy-image policy, like the native pipeline
            print(f"[hf_datasets] decode failed for row {i} ({e}); "
                  "using dummy image")
            gray = np.zeros((self.img_size, self.img_size), np.uint8)
        h, w = gray.shape

        if self.augment and rng is not None:
            # Version A train transform:
            # RandomResizedCrop(img_size) + RandomHorizontalFlip
            box = geo.sample_random_resized_crop(rng, w, h)
            flip = bool(rng.random() < 0.5)
            out = host_resize(gray, box, self.img_size, stretch=True,
                              flip=flip)
        else:
            # Version A eval transform:
            # Resize(shorter→img_size) + CenterCrop(img_size)
            out = _resize_center_crop(gray, self.img_size)
        return {"pixel_values_u8": out,
                "labels": self._labels_of(row)}


def _resize_center_crop(gray: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(size) (shorter side) + CenterCrop(size).
    torchvision truncates the scaled long side (int(), not round())."""
    from PIL import Image
    h, w = gray.shape
    if h <= w:
        nh, nw = size, max(int(w * size / h), size)
    else:
        nw, nh = size, max(int(h * size / w), size)
    img = Image.fromarray(gray).resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(img, np.uint8)
    top = (nh - size) // 2
    left = (nw - size) // 2
    return arr[top:top + size, left:left + size]


def split_hf_dataset(dataset, seed: int = 42):
    """Version A's 80/10/10 scheme on an HF dataset:
    hold out 20% with the seed, split that half/half into val/test.
    Uses :func:`datasets_train_test_split` — bit-identical membership AND
    row order to ``datasets.Dataset.train_test_split(seed=...)`` (PCG64
    permutation), so splits line up sample-for-sample with a
    reference-trained run."""
    from chestxray_vit_tpu_torch.data.metadata import split_80_10_10
    train_idx, val_idx, test_idx = split_80_10_10(range(len(dataset)), seed)
    return (dataset.select(train_idx), dataset.select(val_idx),
            dataset.select(test_idx))


def class_names_of(dataset, label_column: str = "labels") -> List[str]:
    """Class vocabulary from dataset features."""
    feat = dataset.features[label_column]
    inner = getattr(feat, "feature", feat)
    names = getattr(inner, "names", None)
    if names is None:
        raise ValueError(f"column {label_column!r} has no class names")
    return list(names)


def load_hf_dataset(name: str, img_size: int = 384,
                    augment_train: bool = True):
    """``load_dataset`` + split + adapters. Requires network/cache access;
    callers degrade gracefully when unavailable (the native NIH pipeline is
    the primary path).

    Multi-process: the reference's master-gated download barrier (its
    double ``xm.rendezvous('download_only_once')``) — the primary process
    downloads first while the others wait at a barrier, then they load
    from the now-warm shared cache behind a second barrier."""
    import datasets as hfd

    from chestxray_vit_tpu_torch.parallel import distributed as dist

    if dist.is_primary():
        try:
            ds = hfd.load_dataset(name)
        except BaseException:
            # release the waiters before dying — otherwise every
            # non-primary process blocks in the collective forever while
            # the primary's exception kills only its own process
            dist.barrier("download_only_once")
            raise
        dist.barrier("download_only_once")
    else:
        dist.barrier("download_only_once")      # wait for the master's pull
        ds = hfd.load_dataset(name)
    dist.barrier("download_only_once_done")
    base = ds["train"] if "train" in ds else next(iter(ds.values()))
    classes = class_names_of(base)
    train, val, test = split_hf_dataset(base)
    mk = lambda split, aug: HFDatasetAdapter(
        split, classes, img_size=img_size, augment=aug)
    return mk(train, augment_train), mk(val, False), mk(test, False), classes

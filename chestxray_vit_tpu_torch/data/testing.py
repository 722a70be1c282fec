"""Synthetic NIH ChestX-ray14 bucket of the port, a copy of
``chestxray_vit_tpu/data/testing.py``.

Writes the bucket layout the reference reads (``images_001..012/images/
*.png``, the two CSVs, the two list files) into a :class:`MemoryStore`, so
tests and smoke fine-tunes run with no network. Images are deterministic
per-name grayscale PNGs with class-correlated structure, so a small model
learns from them; for the same seed the blobs equal the JAX package's
byte for byte.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from chestxray_vit_tpu_torch.config import NIH_CLASSES
from chestxray_vit_tpu_torch.data.storage import MemoryStore

PATHOLOGIES: Tuple[str, ...] = tuple(
    c for c in NIH_CLASSES if c != "No Finding")


@dataclass
class FakeNIH:
    store: MemoryStore
    image_names: List[str]
    labels_by_name: Dict[str, List[str]]
    bboxes_by_name: Dict[str, Tuple[float, float, float, float]] = field(
        default_factory=dict)


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="PNG")
    return buf.getvalue()


def _render_image(rng: np.random.Generator, labels: Sequence[str],
                  size: int) -> np.ndarray:
    """Noise background + one bright block per pathology at a class-specific
    position — learnable signal, deterministic given the rng."""
    img = rng.integers(20, 60, (size, size), dtype=np.uint8) \
        if size else np.zeros((0, 0), np.uint8)
    n = len(PATHOLOGIES)
    for lab in labels:
        if lab == "No Finding":
            continue
        k = PATHOLOGIES.index(lab)
        cell = max(size // n, 4)
        y = (k * cell) % max(size - cell, 1)
        x = ((k * 37) % n) * cell % max(size - cell, 1)
        img[y:y + cell, x:x + cell] = 220
    return img


def render_array_dataset(
    num_images: int,
    image_size: int = 384,
    seed: int = 0,
    *,
    block_px: Optional[int] = None,
    contrast: int = 40,
    jitter: int = 24,
    no_finding_fraction: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray]:
    """HARD-mode synthetic NIH task as raw arrays (no PNG round-trip).

    The bucket fixture above renders large high-contrast blocks — a model
    saturates AUROC≈1.0 in a few hundred steps, which makes it useless for
    *quality* A/Bs (any lossy accelerator also scores 1.0). This variant is
    deliberately harder so fidelity differences are measurable (the
    token-merging convergence A/B):

    - blocks are small (default ~1.5 patches at 384/16) and low-contrast
      (``contrast`` added onto the 20..60 noise background, not set to 220);
    - block positions jitter ±``jitter`` px per image around the
      class-specific anchor, so the model must localize, not memorize a
      fixed pixel.

    Returns ``(images u8 [N, S, S], labels f32 [N, 15])`` over the sorted
    15-class NIH vocabulary, 'No Finding' multi-hot like
    the reference's label engine.
    """
    rng = np.random.default_rng(seed)
    n_path = len(PATHOLOGIES)
    side = block_px if block_px is not None else max(image_size // 16, 4) + 8
    images = rng.integers(20, 60, (num_images, image_size, image_size),
                          dtype=np.uint8)
    labels = np.zeros((num_images, len(NIH_CLASSES)), np.float32)
    nf_col = NIH_CLASSES.index("No Finding")
    col_of = {c: NIH_CLASSES.index(c) for c in PATHOLOGIES}

    cell = max(image_size // n_path, side + 1)
    for i in range(num_images):
        if i >= n_path and rng.random() < no_finding_fraction:
            labels[i, nf_col] = 1.0
            continue
        if i < n_path:
            ks = [i]              # guarantee every pathology occurs
        else:
            ks = sorted(rng.choice(n_path, size=int(rng.integers(1, 3)),
                                   replace=False))
        for k in ks:
            labels[i, col_of[PATHOLOGIES[k]]] = 1.0
            y0 = (k * cell) % max(image_size - side, 1)
            x0 = ((k * 37) % n_path) * cell % max(image_size - side, 1)
            if jitter:
                y0 = int(np.clip(y0 + rng.integers(-jitter, jitter + 1),
                                 0, image_size - side))
                x0 = int(np.clip(x0 + rng.integers(-jitter, jitter + 1),
                                 0, image_size - side))
            region = images[i, y0:y0 + side, x0:x0 + side].astype(np.int32)
            images[i, y0:y0 + side, x0:x0 + side] = np.clip(
                region + contrast, 0, 255).astype(np.uint8)
    return images, labels


def build_fake_nih(
    num_images: int = 64,
    image_size: int = 64,
    num_test: Optional[int] = None,
    bbox_fraction: float = 0.25,
    seed: int = 0,
    classes: Sequence[str] = PATHOLOGIES,
) -> FakeNIH:
    """Create the full synthetic bucket. ~num_test names (default 20%) land
    in test_list.txt, the rest in train_val_list.txt."""
    rng = np.random.default_rng(seed)
    store = MemoryStore()
    names: List[str] = []
    labels_by_name: Dict[str, List[str]] = {}
    bboxes_by_name: Dict[str, Tuple[float, float, float, float]] = {}

    entry_rows = ["Image Index,Finding Labels,Follow-up #,Patient ID"]
    bbox_rows = ["Image Index,Finding Label,Bbox [x,y,w,h],,"]

    for i in range(num_images):
        name = f"{i:08d}_000.png"
        names.append(name)
        if i < len(classes):
            # guarantee every pathology occurs → the derived vocabulary is
            # always the full class set (NUM_CLASSES is data-derived in the
            # reference,
            labels = [classes[i]]
        elif rng.random() < 0.3:
            labels = ["No Finding"]
        else:
            k = int(rng.integers(1, 3))
            labels = sorted(rng.choice(classes, size=k, replace=False))
        labels_by_name[name] = list(labels)
        img = _render_image(rng, labels, image_size)
        folder = (i % 12) + 1
        store.put(f"images_{folder:03d}/images/{name}", _png_bytes(img))
        entry_rows.append(f"{name},{'|'.join(labels)},{i},{i}")
        if labels != ["No Finding"] and rng.random() < bbox_fraction:
            side = image_size // 3
            x = float(rng.integers(0, image_size - side))
            y = float(rng.integers(0, image_size - side))
            bboxes_by_name[name] = (x, y, float(side), float(side))
            bbox_rows.append(f"{name},{labels[0]},{x},{y},{side},{side},,")

    n_test = num_test if num_test is not None else max(num_images // 5, 1)
    test_names = names[-n_test:]
    train_val_names = names[:-n_test]

    store.put("Data_Entry_2017.csv", "\n".join(entry_rows).encode())
    store.put("BBox_List_2017.csv", "\n".join(bbox_rows).encode())
    store.put("train_val_list.txt", "\n".join(train_val_names).encode())
    store.put("test_list.txt", "\n".join(test_names).encode())

    return FakeNIH(store=store, image_names=names,
                   labels_by_name=labels_by_name,
                   bboxes_by_name=bboxes_by_name)

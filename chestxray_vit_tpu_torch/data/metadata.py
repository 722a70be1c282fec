"""Host-side metadata engine of the port, a copy of
``chestxray_vit_tpu/data/metadata.py``: CSV parsing, label normalization,
multi-hot binarization, bbox tables, and dataset splits, with the
reference's semantics (its 'Finding Labels' rules, the sorted 15-class
vocabulary, sklearn's ``train_test_split`` and ``datasets``'
``train_test_split`` permutations, the dataset index's filtering and
subsetting). Pure Python and NumPy; ``BBox`` lives in ``data/geometry.py``.
"""

from __future__ import annotations

import csv
import io
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from chestxray_vit_tpu_torch.data.geometry import BBox

NO_FINDING = "No Finding"


# ---------------------------------------------------------------------------
# Label normalization
# ---------------------------------------------------------------------------

def normalize_finding_labels(raw: str) -> str:
    """Normalize one 'Finding Labels' cell.

    Reference rules:
    - multi-label strings (containing '|') drop the 'No Finding' token and
      strip whitespace from each remaining token;
    - an empty/blank string becomes 'No Finding'.
    """
    s = (raw or "").strip()
    if "|" in s:
        tokens = [t.strip() for t in s.split("|")]
        tokens = [t for t in tokens if t and t != NO_FINDING]
        s = "|".join(tokens)
    if not s:
        s = NO_FINDING
    return s


def labels_to_list(normalized: str) -> List[str]:
    """'A|B' → ['A', 'B'] (the reference's ``.split('|')``)."""
    return normalized.split("|")


def build_vocabulary(normalized_labels: Sequence[str]) -> List[str]:
    """Sorted unique label vocabulary, force-including 'No Finding'.

    Reference: ``sorted(set('|'.join(all).split('|')))``,
    append 'No Finding' if absent, re-sort. Yields the canonical 15-class
    NIH vocabulary on the full dataset.
    """
    if normalized_labels:
        vocab = set("|".join(normalized_labels).split("|"))
        vocab.discard("")
    else:
        vocab = set()
    vocab.add(NO_FINDING)
    return sorted(vocab)


# ---------------------------------------------------------------------------
# Multi-hot binarizer (sklearn MultiLabelBinarizer parity,
# ---------------------------------------------------------------------------

class LabelBinarizer:
    """Drop-in for sklearn ``MultiLabelBinarizer(classes=...)``: fixed class
    order, multi-hot transform, unknown labels ignored (sklearn warns and
    drops labels outside ``classes`` at transform time)."""

    def __init__(self, classes: Sequence[str]):
        self.classes_ = list(classes)
        self._index = {c: i for i, c in enumerate(self.classes_)}

    def transform(self, label_lists: Sequence[Sequence[str]]) -> np.ndarray:
        out = np.zeros((len(label_lists), len(self.classes_)), dtype=np.int64)
        for row, labels in enumerate(label_lists):
            for lab in labels:
                idx = self._index.get(lab)
                if idx is not None:
                    out[row, idx] = 1
        return out

    def inverse_transform(self, multi_hot: np.ndarray) -> List[Tuple[str, ...]]:
        return [tuple(c for c, v in zip(self.classes_, row) if v)
                for row in np.asarray(multi_hot)]


# ---------------------------------------------------------------------------
# BBox CSV
# ---------------------------------------------------------------------------

def _clean_column_name(name: str) -> str:
    """Strip '[' / ']' and convert spaces to underscores:
    'Bbox [x' → 'Bbox_x', 'h]' → 'h', 'Image Index' → 'Image_Index'."""
    cleaned = re.sub(r"[\[\]]", "", name).strip()
    return cleaned.replace(" ", "_")


def parse_bbox_csv(text: str) -> Dict[str, List[BBox]]:
    """Parse BBox_List_2017.csv into {image_name: [BBox, ...]}.

    Matches the reference: clean column names, drop
    'Unnamed*' columns, group rows by Image_Index preserving file order.
    Malformed rows are skipped (the reference wraps the whole load in
    try/except and falls back to an empty dict; we degrade per-row).
    """
    bbox_dict: Dict[str, List[BBox]] = {}
    reader = csv.reader(io.StringIO(text))
    try:
        header = next(reader)
    except StopIteration:
        return bbox_dict
    cols = [_clean_column_name(c) for c in header]
    keep = {name: i for i, name in enumerate(cols)
            if not name.startswith("Unnamed")}
    required = ("Image_Index", "Finding_Label", "Bbox_x", "y", "w", "h")
    if any(r not in keep for r in required):
        return bbox_dict  # reference: print error, empty dict
    for row in reader:
        if not row:
            continue
        try:
            name = row[keep["Image_Index"]]
            bbox = BBox(
                label=row[keep["Finding_Label"]],
                x=float(row[keep["Bbox_x"]]),
                y=float(row[keep["y"]]),
                w=float(row[keep["w"]]),
                h=float(row[keep["h"]]),
            )
        except (ValueError, IndexError):
            continue
        bbox_dict.setdefault(name, []).append(bbox)
    return bbox_dict


# ---------------------------------------------------------------------------
# Data_Entry CSV
# ---------------------------------------------------------------------------

@dataclass
class DataEntry:
    """One row of Data_Entry_2017.csv after normalization."""
    image_index: str
    finding_labels: str          # normalized '|'-joined string
    label_list: List[str] = field(default_factory=list)


def parse_data_entry_csv(text: str) -> Tuple[List[DataEntry], List[str]]:
    """Parse Data_Entry_2017.csv → (entries, vocabulary).

    Normalizes every 'Finding Labels' cell and derives the
    sorted class vocabulary. Raises ValueError when the file
    yields zero classes — the reference hard-exits on NUM_CLASSES == 0
   .
    """
    entries: List[DataEntry] = []
    reader = csv.reader(io.StringIO(text))
    try:
        header = next(reader)
    except StopIteration:
        raise ValueError("empty Data_Entry CSV")
    idx_by_name = {name.strip(): i for i, name in enumerate(header)}
    try:
        i_img = idx_by_name["Image Index"]
        i_lab = idx_by_name["Finding Labels"]
    except KeyError as e:
        raise ValueError(f"Data_Entry CSV missing column {e}") from e
    for row in reader:
        if not row or len(row) <= max(i_img, i_lab):
            continue
        normalized = normalize_finding_labels(row[i_lab])
        entries.append(DataEntry(
            image_index=row[i_img],
            finding_labels=normalized,
            label_list=labels_to_list(normalized),
        ))
    if not entries:
        # build_vocabulary force-includes 'No Finding', so the zero-class
        # check below can never fire on its own — an empty/header-only CSV
        # must fail HERE (the reference's fatal metadata guard), not much
        # later as a confusing 'zero full batches'
        raise ValueError("Data_Entry CSV contains no data rows")
    vocab = build_vocabulary([e.finding_labels for e in entries])
    if not vocab:
        raise ValueError("derived zero classes from Data_Entry CSV")
    return entries, vocab


def parse_list_file(text: str) -> List[str]:
    """train_val_list.txt / test_list.txt: one image filename per line
   ."""
    return [line.strip() for line in text.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# Splits
# ---------------------------------------------------------------------------

def train_test_split(items: Sequence, test_size: float,
                     seed: int) -> Tuple[list, list]:
    """Bit-exact reimplementation of sklearn ``train_test_split`` with
    shuffle (its default): n_test = ceil(test_size * n); a seed-42
    ``RandomState.permutation`` assigns the first n_test indices to test and
    the next n_train to train uses test_size=0.15, random_state=42).
    """
    n = len(items)
    n_test = int(math.ceil(test_size * n))
    n_train = n - n_test
    perm = np.random.RandomState(seed).permutation(n)
    test_idx = perm[:n_test]
    train_idx = perm[n_test:n_test + n_train]
    items = list(items)
    return [items[i] for i in train_idx], [items[i] for i in test_idx]


def datasets_train_test_split(items: Sequence, test_size: float,
                              seed: int) -> Tuple[list, list]:
    """Bit-exact reimplementation of ``datasets.Dataset.train_test_split``
    (the Version A reference's splitter, ViT-Training.py:39-46), which
    permutes with ``np.random.default_rng`` (PCG64) — NOT sklearn's legacy
    ``RandomState`` (MT19937). The two generators produce disjoint
    permutations for the same seed, so split membership differs; verified
    empirically against the real ``datasets`` library (n_test = ceil,
    test = perm[:n_test], train = perm[n_test:n_test+n_train], order kept).
    """
    n = len(items)
    n_test = int(math.ceil(test_size * n))
    n_train = n - n_test
    perm = np.random.default_rng(seed).permutation(n)
    items = list(items)
    return ([items[i] for i in perm[n_test:n_test + n_train]],
            [items[i] for i in perm[:n_test]])


def split_80_10_10(items: Sequence, seed: int = 42) -> Tuple[list, list, list]:
    """Version A's scheme (ViT-Training.py:39-46): hold out 20% with seed,
    then split the held-out half/half into val and test with the same seed.
    Uses the datasets-library permutation (PCG64) so membership matches a
    reference-trained run sample-for-sample; the sklearn-semantics
    :func:`train_test_split` remains the Version B official-lists splitter."""
    train, held = datasets_train_test_split(items, test_size=0.2, seed=seed)
    val, test = datasets_train_test_split(held, test_size=0.5, seed=seed)
    return train, val, test


# ---------------------------------------------------------------------------
# Dataset index
# ---------------------------------------------------------------------------

@dataclass
class DatasetIndex:
    """Immutable index over one split: filenames, pre-encoded multi-hot
    labels, and per-image bboxes. Mirrors NIHChestDataset.__init__
   : filter by membership in the split's file list, keep the
    CSV's row order, optional head-slice subsetting, pre-encoded labels."""

    filenames: List[str]
    labels: np.ndarray                       # int64 [N, C]
    classes: List[str]
    bboxes: Dict[str, List[BBox]] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.filenames)

    def bbox_for(self, name: str) -> Optional[BBox]:
        """First bbox only, like the reference."""
        entries = self.bboxes.get(name)
        return entries[0] if entries else None


def build_dataset_index(
    entries: Sequence[DataEntry],
    file_list: Sequence[str],
    binarizer: LabelBinarizer,
    bbox_dict: Optional[Dict[str, List[BBox]]] = None,
    use_subset: Optional[int] = None,
) -> DatasetIndex:
    """Build the index for one split.

    Matches NIHChestDataset.__init__: rows filtered by
    ``isin(file_list)`` (CSV order preserved, like
    ``df[df['Image Index'].isin(lst)]``), then head-sliced to
    ``use_subset`` when given, then labels pre-encoded via the binarizer.
    """
    members = set(file_list)
    selected = [e for e in entries if e.image_index in members]
    if use_subset is not None:
        selected = selected[:use_subset]
    filenames = [e.image_index for e in selected]
    labels = binarizer.transform([e.label_list for e in selected])
    return DatasetIndex(
        filenames=filenames,
        labels=labels,
        classes=list(binarizer.classes_),
        bboxes=dict(bbox_dict or {}),
    )

"""NaViT-style packed variable-resolution batching: the port's own copy of
``chestxray_vit_tpu/data/packing.py`` (numpy arrays; the epoch order is
``data/pipeline.py``'s).

Multiple images of different resolutions share one token sequence,
isolated by segment ids and block-diagonal attention
(``ops.flash_attention.flash_attention_packed``). Static shapes throughout:
sequences are ``seq_len`` tokens, shorter packs are padded with segment id
-1.

Host side (this module): greedy first-fit packing, per-image resize to its
patch grid, patch extraction, position-index assignment into the
concatenated multi-grid table that ``models/packed.py`` builds on device.
``iterate_packed_batches`` and ``sample_token_counts`` are duck-typed over
``index`` (``filenames``, ``labels``, ``len``) and ``store`` (``get``).
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from chestxray_vit_tpu_torch.config import PROCESSOR_MEAN, PROCESSOR_STD
from chestxray_vit_tpu_torch.data import decode as dec
from chestxray_vit_tpu_torch.data import geometry as geo
from chestxray_vit_tpu_torch.data.geometry import host_resize
from chestxray_vit_tpu_torch.data.pipeline import epoch_order

PAD_SEGMENT = -1


def grid_table_offsets(grids: Sequence[int]) -> Dict[int, int]:
    """Flat offsets of each grid's block inside the concatenated
    position-embedding table [sum(g²), D]."""
    offsets, cursor = {}, 0
    for g in grids:
        offsets[g] = cursor
        cursor += g * g
    return offsets


def choose_grid(h: int, w: int, patch: int, grids: Sequence[int]) -> int:
    """Pick the largest allowed grid not exceeding the image's native patch
    capacity (min side // patch), clamped to the smallest grid."""
    native = max(min(h, w) // patch, 1)
    usable = [g for g in grids if g <= native]
    return max(usable) if usable else min(grids)


@dataclass
class PackedBatch:
    """Device-ready packed batch (all static shapes)."""
    tokens: np.ndarray        # f32 [B, S, patch*patch*3] normalized patches
    segment_ids: np.ndarray   # i32 [B, S]; PAD_SEGMENT on padding
    pos_indices: np.ndarray   # i32 [B, S] into the concat pos table
    pool_weights: np.ndarray  # f32 [B, max_imgs, S] mean-pool per image
    labels: np.ndarray        # f32 [B, max_imgs, C]
    image_mask: np.ndarray    # bool [B, max_imgs] true where a real image
    n_images: int


def _image_tokens(gray: np.ndarray, grid: int, patch: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One image → (tokens [g², patch²·3], pos ids-in-grid [g²])."""
    size = grid * patch
    h, w = gray.shape
    resized = host_resize(gray, geo.full_image_box(w, h), size)
    x = resized.astype(np.float32) / 255.0
    rgb = (x[..., None] - np.asarray(PROCESSOR_MEAN, np.float32)) \
        / np.asarray(PROCESSOR_STD, np.float32)              # [size, size, 3]
    p = rgb.reshape(grid, patch, grid, patch, 3).transpose(0, 2, 1, 3, 4)
    tokens = p.reshape(grid * grid, patch * patch * 3)
    pos = np.arange(grid * grid, dtype=np.int32)
    return tokens, pos


def iterate_packed_batches(
    index,                                  # metadata.DatasetIndex
    blob_map: Dict[str, str],
    store,
    *,
    batch_seqs: int = 8,
    patch: int = 16,
    seq_len: int = 1152,
    grids: Sequence[int] = (16, 24, 32),
    max_imgs_per_seq: Optional[int] = None,
    epoch: int = 0,
    shuffle: bool = True,
    seed: int = 42,
    num_workers: int = 8,
    skip_images: int = 0,
    host_shard: Optional[Tuple[int, int]] = None,
):
    """Stream the NIH pipeline into fixed-shape packed batches.

    Decodes images on a thread pool, next-fit packs them into ``seq_len``
    sequences, and yields dict batches of exactly ``batch_seqs`` sequences
    (static shapes for the jitted packed train step). The tail batch is
    padded with empty sequences. Yields the same keys
    ``make_packed_train_step`` consumes, plus two host-side counters the
    caller pops before device placement:

    - ``n_seqs``: how many sequences are real (the padded tail batch has
      fewer than ``batch_seqs``);
    - ``n_images``: images in this batch. Emitted batches always cover a
      PREFIX of the epoch order (the open in-flight pack holds the newest
      suffix), so a checkpoint cursor can store the cumulative image count
      and resume with ``skip_images`` — no re-fetch/re-decode of trained
      data, and next-fit packing of the remaining stream is bit-identical
      to the uninterrupted run's.

    ``host_shard=(rank, num_hosts)`` deterministically shards the epoch
    image stream BEFORE packing (strided slice ``order[rank::num_hosts]``):
    each host decodes and packs only its shard, so multi-host packed
    training scales I/O out with hosts. ``skip_images`` then counts images
    of THIS host's shard (each host resumes from its own cursor entry —
    pack boundaries are content-dependent, so per-host consumption
    differs).
    """

    offsets = grid_table_offsets(grids)
    n = len(index)
    order = epoch_order(n, epoch, seed, shuffle)
    if host_shard is not None:
        rank, num_hosts = host_shard
        order = order[rank::num_hosts]
    if skip_images:
        order = order[skip_images:]   # resume: skip BEFORE any fetch/decode
    num_classes = index.labels.shape[1]

    def load(i: int):
        name = index.filenames[i]
        blob = blob_map.get(name)
        data = None
        if blob is not None:
            try:
                data = store.get(blob)
            except Exception:                           # noqa: BLE001
                data = None
        gray = dec.safe_decode_gray(data)
        g = choose_grid(gray.shape[0], gray.shape[1], patch, grids)
        tokens, pos = _image_tokens(gray, g, patch)
        return tokens, pos + offsets[g], index.labels[i].astype(np.float32)

    cap = max_imgs_per_seq or seq_len // min(g * g for g in grids)
    closed: List[List[tuple]] = []
    current: List[tuple] = []
    used = 0

    def assemble(seqs: List[List[tuple]]) -> dict:
        max_imgs = cap
        b = batch_seqs
        patch_dim = patch * patch * 3
        out = {
            "tokens": np.zeros((b, seq_len, patch_dim), np.float32),
            "segment_ids": np.full((b, seq_len), PAD_SEGMENT, np.int32),
            "pos_indices": np.zeros((b, seq_len), np.int32),
            "pool_weights": np.zeros((b, max_imgs, seq_len), np.float32),
            "labels": np.zeros((b, max_imgs, num_classes), np.float32),
            "image_mask": np.zeros((b, max_imgs), bool),
        }
        for s, members in enumerate(seqs):
            cursor = 0
            for slot, (t, p, lab) in enumerate(members):
                m = t.shape[0]
                out["tokens"][s, cursor:cursor + m] = t
                out["segment_ids"][s, cursor:cursor + m] = slot
                out["pos_indices"][s, cursor:cursor + m] = p
                out["pool_weights"][s, slot, cursor:cursor + m] = 1.0 / m
                out["labels"][s, slot] = lab
                out["image_mask"][s, slot] = True
                cursor += m
        out["n_seqs"] = np.asarray(len(seqs), np.int32)
        out["n_images"] = np.asarray(sum(len(s) for s in seqs), np.int32)
        return out

    # bounded submission: keep at most ~4 batches of decodes in flight so a
    # slow consumer doesn't buffer the whole epoch's tokens in host memory
    max_inflight = max(num_workers, 1) * 4
    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        pending: "queue.Queue" = queue.Queue()
        it = iter(int(i) for i in order)

        def submit() -> bool:
            try:
                i = next(it)
            except StopIteration:
                return False
            pending.put(pool.submit(load, i))
            return True

        for _ in range(max_inflight):
            if not submit():
                break
        while not pending.empty():
            fut = pending.get()
            submit()
            tokens, pos, lab = fut.result()
            m = tokens.shape[0]
            if m > seq_len:
                # same guard as pack_images: without it the close-and-retry
                # below emits an empty pack and assemble crashes with an
                # opaque broadcast error mid-epoch
                raise ValueError(
                    f"an image needs {m} tokens > seq_len {seq_len}; "
                    f"raise seq_len or use smaller grids")
            if used + m > seq_len or len(current) >= cap:
                closed.append(current)
                current, used = [], 0
                if len(closed) == batch_seqs:
                    yield assemble(closed)
                    closed = []
            current.append((tokens, pos, lab))
            used += m
    if current:
        closed.append(current)
    if closed:
        yield assemble(closed)


def sample_token_counts(index, blob_map: Dict[str, str], store, *,
                        patch: int = 16,
                        grids: Sequence[int] = (16, 24, 32),
                        sample: int = 128,
                        num_workers: int = 8) -> List[int]:
    """Token counts (grid²) of an evenly-spaced sample of the dataset —
    the cheap census behind :func:`estimate_sequences_per_epoch`. Decodes
    only ``sample`` images (header dims decide the grid, but stores serve
    whole blobs, so a bounded decode sample is the honest cheap pass)."""

    n = len(index)
    if n == 0:
        return []
    idxs = np.unique(np.linspace(0, n - 1, min(sample, n)).astype(int))

    def count(i: int) -> int:
        blob = blob_map.get(index.filenames[int(i)])
        data = None
        if blob is not None:
            try:
                data = store.get(blob)
            except Exception:                           # noqa: BLE001
                data = None
        gray = dec.safe_decode_gray(data)
        g = choose_grid(gray.shape[0], gray.shape[1], patch, grids)
        return g * g

    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        return list(pool.map(count, idxs))


def estimate_sequences_per_epoch(token_counts: Sequence[int], n_images: int,
                                 seq_len: int, cap: int) -> int:
    """Simulate the next-fit packer over ``n_images`` draws cycling the
    sampled ``token_counts``: how many sequences one epoch produces.
    Exact when resolutions are uniform (NIH natives are all 1024²); a
    sampled estimate otherwise — far tighter than a min-tokens bound."""
    if not token_counts or n_images == 0:
        return 0
    seqs, used, members = 0, 0, 0
    for t in range(n_images):
        m = token_counts[t % len(token_counts)]
        if used + m > seq_len or members >= cap:
            seqs += 1
            used, members = 0, 0
        used += m
        members += 1
    return seqs + (1 if members else 0)


def pack_images(
    images: Sequence[np.ndarray],          # u8 grayscale, any sizes
    labels: Sequence[np.ndarray],          # [C] multi-hot each
    patch: int = 16,
    seq_len: int = 1152,
    grids: Sequence[int] = (16, 24, 32),   # 256 / 384 / 512 px
    max_imgs_per_seq: Optional[int] = None,
) -> PackedBatch:
    """Greedy first-fit packing of variable-resolution images into
    fixed-length sequences."""
    offsets = grid_table_offsets(grids)
    num_classes = len(labels[0])
    per_image = []
    for img, lab in zip(images, labels):
        g = choose_grid(img.shape[0], img.shape[1], patch, grids)
        tokens, pos = _image_tokens(img, g, patch)
        per_image.append((tokens, pos + offsets[g], np.asarray(lab,
                                                               np.float32)))

    # first-fit decreasing by token count, capped per-sequence image count
    order = sorted(range(len(per_image)),
                   key=lambda i: -per_image[i][0].shape[0])
    cap = max_imgs_per_seq if max_imgs_per_seq else len(per_image)
    seqs: List[List[int]] = []
    space: List[int] = []
    for i in order:
        n = per_image[i][0].shape[0]
        if n > seq_len:
            raise ValueError(f"image {i} needs {n} tokens > seq_len {seq_len}")
        for s, free in enumerate(space):
            if free >= n and len(seqs[s]) < cap:
                seqs[s].append(i)
                space[s] -= n
                break
        else:
            seqs.append([i])
            space.append(seq_len - n)

    max_imgs = max_imgs_per_seq or max(len(s) for s in seqs)
    b = len(seqs)
    patch_dim = patch * patch * 3
    tokens = np.zeros((b, seq_len, patch_dim), np.float32)
    seg = np.full((b, seq_len), PAD_SEGMENT, np.int32)
    pos = np.zeros((b, seq_len), np.int32)
    pool = np.zeros((b, max_imgs, seq_len), np.float32)
    labs = np.zeros((b, max_imgs, num_classes), np.float32)
    mask = np.zeros((b, max_imgs), bool)

    for s, members in enumerate(seqs):
        cursor = 0
        for slot, i in enumerate(members):
            t, p, lab = per_image[i]
            n = t.shape[0]
            tokens[s, cursor:cursor + n] = t
            seg[s, cursor:cursor + n] = slot
            pos[s, cursor:cursor + n] = p
            pool[s, slot, cursor:cursor + n] = 1.0 / n
            labs[s, slot] = lab
            mask[s, slot] = True
            cursor += n
    return PackedBatch(tokens=tokens, segment_ids=seg, pos_indices=pos,
                       pool_weights=pool, labels=labs, image_mask=mask,
                       n_images=len(per_image))

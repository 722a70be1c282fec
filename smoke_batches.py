"""Seeded synthetic batches of the port's device scripts (chip_smoke.py,
profile_step.py, tile_skip_probe.py), so that they measure the same data:
bench.py's dense batch, the packed probe's batch, the mixed-resolution
packed batch, the segment-id layouts of the kernel checks and the share of
attention tiles a layout lets the segment kernels skip. Imports numpy and
torch at the top; the port's packer inside the functions.
"""

from __future__ import annotations

import numpy as np
import torch

PACKED_SEQS, PACKED_SEQ_LEN = 32, 1152      # tools/packed_probe.py's batch
TOME_R, TOME_SCHEDULE = 16, "decreasing"
PACKED_KEYS = ("tokens", "segment_ids", "pos_indices", "pool_weights",
               "labels", "image_mask")


def bench_batch(n: int, seed: int, device, img_size: int = 384) -> dict:
    """bench.py's synthetic batch: standard-normal f32 NHWC pixels and
    Bernoulli(0.2) labels over 15 classes, from numpy's generator
    (``img_size`` pixels a side: 384 for ViT-B/16, 224 for ViT-H/14)."""
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((n, img_size, img_size, 3)).astype(
        np.float32)
    labels = (rng.random((n, 15)) < 0.2).astype(np.float32)
    return {"pixel_values": torch.from_numpy(pixels).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def packed_batch(sizes, rng, device, max_imgs_per_seq=None) -> dict:
    """Seeded u8 images of the given sizes and Bernoulli(0.2) labels through
    the port's ``pack_images`` (1152-token sequences, grids 16/24/32), on
    ``device``; ``n_images`` counts the real images."""
    from chestxray_vit_tpu_torch.data import packing

    images = [rng.integers(0, 255, (s, s), np.uint8) for s in sizes]
    labels = [(rng.random(15) < 0.2).astype(np.float32) for _ in sizes]
    pb = packing.pack_images(images, labels, patch=16,
                             seq_len=PACKED_SEQ_LEN,
                             max_imgs_per_seq=max_imgs_per_seq)
    batch = {k: torch.from_numpy(getattr(pb, k)).to(device)
             for k in PACKED_KEYS}
    batch["n_images"] = int(batch["image_mask"].sum())
    return batch


def packed_probe_batch(device, n_seqs: int = PACKED_SEQS) -> dict:
    """tools/packed_probe.py's batch: two 384 x 384 images (576 tokens
    each) per 1152-token sequence, numpy seed 0."""
    return packed_batch([384] * (2 * n_seqs), np.random.default_rng(0),
                        device, max_imgs_per_seq=2)


def packed_mixed_batch(device, n_seqs: int = PACKED_SEQS) -> dict:
    """``n_seqs`` sequences packed from 256 / 384 / 512 px images (256, 576
    and 1024 tokens) whose sizes are drawn from numpy seed 0: as many
    images as it takes to fill them."""
    sizes = np.random.default_rng(0).choice([256, 384, 512], 4 * n_seqs)
    n = n_seqs
    while True:
        batch = packed_batch(sizes[:n].tolist(), np.random.default_rng(1),
                             "cpu")
        if batch["tokens"].shape[0] >= n_seqs:
            break
        n += 2
    return {k: v[:n_seqs].to(device) if k != "n_images"
            else int(batch["image_mask"][:n_seqs].sum())
            for k, v in batch.items()}


def tensors(batch: dict) -> dict:
    """The batch without its ``n_images`` count: what the step takes."""
    return {k: batch[k] for k in PACKED_KEYS}


def merged_order(ids: np.ndarray) -> np.ndarray:
    """Ids in the order a token merge leaves them: the even positions,
    then the odd ones."""
    return np.concatenate([ids[0::2], ids[1::2]])


def packed_layouts(batch: int, device="cuda") -> dict:
    """name → int32 ids [batch, S] (−1 is padding) of the kernel checks'
    three layouts: two segments of 576; mixed with padding; ragged with
    interleaved ids (S = 1136)."""
    mixed = [np.repeat([0, -1], [1024, 128]),
             np.repeat([0, 1, 2, -1], [576, 256, 256, 64]),
             np.repeat([0, 1, 2, 3, -1], [256, 256, 256, 256, 128])]
    two = np.repeat([0, 1], 576)
    rows = {"two_segments": [two] * batch,
            "mixed_pad": [mixed[i % 3] for i in range(batch)],
            "interleaved_ragged": [merged_order(two)[:1136]] * batch}
    return {k: torch.tensor(np.stack(v), dtype=torch.int32, device=device)
            for k, v in rows.items()}


def skipped_tile_share(seg: torch.Tensor) -> dict:
    """Of the 64 x 64 (query tile, key tile) pairs of a batch: the share
    that holds no same-segment pair (what an exact skip would leave out)
    and the share the kernels' id-range test skips."""
    ids = seg.cpu().numpy()
    empty = ranged = total = 0
    for row in ids:
        tiles = [row[i:i + 64] for i in range(0, len(row), 64)]
        for qt in tiles:
            for kt in tiles:
                total += 1
                empty += not np.isin(kt, qt).any()
                ranged += not ((kt >= qt.min()) & (kt <= qt.max())).any()
    return {"tiles_without_a_pair": empty / total,
            "tiles_skipped_by_range": ranged / total}

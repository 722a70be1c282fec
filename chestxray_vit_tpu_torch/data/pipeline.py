"""Host input pipeline of the port, ported from
``chestxray_vit_tpu/data/pipeline.py``: dataset assembly, per-sample
loading, threaded prefetch, and the host→device staging of batches.

A thread pool decodes ahead of the step loop into a bounded queue, batches
are stacked into contiguous numpy arrays (``iterate_batches``, the JAX
package's, array for array), and ``DevicePrefetcher`` copies the next
batches to the card on a side stream while the current step runs.

Two preprocessing placements (``cfg.data.preprocess_placement``; see
``ops/preprocess.py``):
- ``host``: decode → crop/pad/resize on the host → ship u8 img² grayscale
  (normalization runs on the device inside the step);
- ``device``: decode onto a fixed u8 canvas → ship canvas and crop box, and
  the device op crops, pads, resizes and normalizes.

Augmentation draws from ``np.random.default_rng((seed, epoch, bi, j))``,
keyed on the batch's absolute index in the epoch and the sample's position
in the global batch, so a resumed run (``skip_batches``) sees the same
crops and flips as an uninterrupted one.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from chestxray_vit_tpu_torch.config import DataConfig
from chestxray_vit_tpu_torch.data import decode as dec
from chestxray_vit_tpu_torch.data import geometry as geo
from chestxray_vit_tpu_torch.data import metadata as md
from chestxray_vit_tpu_torch.data.geometry import host_resize
from chestxray_vit_tpu_torch.data.storage import (Store, build_blob_map,
                                                  open_store)


# ---------------------------------------------------------------------------
# Dataset assembly
# ---------------------------------------------------------------------------

@dataclass
class DatasetBundle:
    """Everything the trainer needs: splits, vocabulary, blob map, store."""
    train: md.DatasetIndex
    val: md.DatasetIndex
    test: md.DatasetIndex
    classes: List[str]
    blob_map: Dict[str, str]
    store: Store


def build_datasets(cfg: DataConfig, store: Optional[Store] = None
                   ) -> DatasetBundle:
    """The reference's metadata phase as one function: CSVs →
    entries/vocab/bboxes, blob map, official-list or 80/10/10 split,
    subsetting (val = N // 5)."""
    store = store if store is not None else open_store(cfg)

    entries, vocab = md.parse_data_entry_csv(
        store.get(cfg.data_entry_csv).decode())
    try:
        bboxes = md.parse_bbox_csv(store.get(cfg.bbox_csv).decode())
    except Exception as e:                               # noqa: BLE001
        print(f"[pipeline] bbox csv unavailable ({e}); continuing without")
        bboxes = {}
    if not cfg.use_bbox_roi:
        bboxes = {}
    blob_map = build_blob_map(store, cfg)
    binarizer = md.LabelBinarizer(vocab)

    if cfg.split_scheme == "official_lists":
        train_val = md.parse_list_file(store.get(cfg.train_val_list).decode())
        test = md.parse_list_file(store.get(cfg.test_list).decode())
        train, val = md.train_test_split(
            train_val, cfg.val_fraction, cfg.split_seed)
    elif cfg.split_scheme == "random_80_10_10":
        all_names = [e.image_index for e in entries]
        train, val, test = md.split_80_10_10(all_names, cfg.split_seed)
    else:
        raise ValueError(f"unknown split_scheme {cfg.split_scheme!r}")

    sub = cfg.use_subset_data
    return DatasetBundle(
        train=md.build_dataset_index(entries, train, binarizer, bboxes, sub),
        val=md.build_dataset_index(entries, val, binarizer, bboxes,
                                   sub // 5 if sub else None),
        test=md.build_dataset_index(entries, test, binarizer, bboxes, sub),
        classes=list(vocab),
        blob_map=blob_map,
        store=store,
    )


# ---------------------------------------------------------------------------
# Per-sample loading
# ---------------------------------------------------------------------------

@dataclass
class SampleLoader:
    """Loads one sample end to end: fetch, decode, crop (the first bbox, or
    the random-resized crop and flip when augmenting), and the placement's
    host half."""
    index: md.DatasetIndex
    blob_map: Dict[str, str]
    store: Store
    img_size: int = 384
    placement: str = "host"          # 'host' | 'device'
    canvas_size: int = 1024
    augment: bool = False            # Version A train transforms
    prefer_native_decode: bool = True

    def _fetch(self, name: str) -> Optional[bytes]:
        blob = self.blob_map.get(name)
        if blob is None:
            return None
        try:
            return self.store.get(blob)
        except Exception as e:                           # noqa: BLE001
            print(f"[pipeline] fetch {name} failed: {e}")
            return None

    def load(self, i: int, rng: Optional[np.random.Generator] = None
             ) -> Dict[str, np.ndarray]:
        name = self.index.filenames[i]
        labels = self.index.labels[i].astype(np.float32)
        gray = dec.safe_decode_gray(
            self._fetch(name), dummy_size=(self.img_size, self.img_size),
            prefer_native=self.prefer_native_decode)
        h, w = gray.shape

        flip = False
        if self.augment and rng is not None:
            box = geo.sample_random_resized_crop(rng, w, h)
            flip = bool(rng.random() < 0.5)
            stretch = True
        else:
            box = geo.select_crop(self.index.bbox_for(name), w, h)
            stretch = False

        if self.placement == "host":
            img = host_resize(gray, box, self.img_size, stretch, flip,
                              prefer_native=self.prefer_native_decode)
            return {"pixel_values_u8": img, "labels": labels}

        # device placement: fixed canvas + crop params
        c = self.canvas_size
        canvas = np.zeros((c, c), np.uint8)
        ch, cw = min(h, c), min(w, c)
        canvas[:ch, :cw] = gray[:ch, :cw]
        # re-clamp the crop window into the (possibly clipped) canvas extent
        left = min(box.left, max(cw - 1, 0))
        top = min(box.top, max(ch - 1, 0))
        box = geo.CropBox(left, top,
                          max(1, min(box.width, cw - left)),
                          max(1, min(box.height, ch - top)))
        return {
            "canvas_u8": canvas,
            "boxes": np.asarray([box.left, box.top, box.width, box.height],
                                np.int32),
            "flips": np.asarray(flip),
            "stretches": np.asarray(stretch),
            "labels": labels,
        }


# ---------------------------------------------------------------------------
# Batched iteration with threaded prefetch
# ---------------------------------------------------------------------------

def _stack(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """collate_fn: stack each field."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def epoch_order(n: int, epoch: int, seed: int, shuffle: bool) -> np.ndarray:
    """The sample order of an epoch: a permutation seeded with
    ``seed + epoch``, or ``arange`` without shuffling."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(seed + epoch).permutation(n)


def iterate_batches(
    loader: SampleLoader,
    batch_size: int,
    *,
    epoch: int = 0,
    shuffle: bool = False,
    seed: int = 42,
    num_workers: int = 8,
    prefetch_batches: int = 4,
    drop_last: bool = False,
    pad_last: bool = False,
    skip_batches: int = 0,
    host_range: Optional[Tuple[int, int]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked numpy batches, decoding ahead with a thread pool.

    ``pad_last`` repeats the final sample up to a full batch and adds a
    ``num_valid`` field: eval keeps static shapes without dropping
    samples. ``skip_batches`` drops the first k batches BEFORE any
    fetch/decode: a mid-epoch resume replays no I/O for data it discards.
    ``host_range=(start, stop)`` loads only that slice of every global
    batch (the multi-process loader of the JAX package); augmentation
    streams key on the GLOBAL in-batch position, so the union of the
    slices equals the full batch. With ``pad_last``, ``num_valid`` counts
    the global batch's valid samples.
    """
    n = len(loader.index)
    order = epoch_order(n, epoch, seed, shuffle)
    batches: List[np.ndarray] = [
        order[i:i + batch_size] for i in range(0, n, batch_size)]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    if (host_range is not None and not pad_last and batches
            and len(batches[-1]) < batch_size):
        raise ValueError(
            "host_range requires drop_last or pad_last when the dataset "
            f"size ({n}) does not divide the global batch ({batch_size})")
    if skip_batches:
        batches = batches[skip_batches:]
    if not batches:
        return

    def make_load_batch(sample_pool: ThreadPoolExecutor):
        def load_one(bi: int, j: int, i: int) -> Dict[str, np.ndarray]:
            rng = (np.random.default_rng((seed, epoch, bi, j))
                   if loader.augment else None)
            return loader.load(i, rng)

        def load_batch(args: Tuple[int, np.ndarray]) -> Dict[str, np.ndarray]:
            bi, idxs = args
            start, stop = host_range if host_range is not None \
                else (0, batch_size)
            sel = idxs[start:stop]
            # one batch's samples fan out over the whole sample pool
            futs = [sample_pool.submit(load_one, bi, j, int(i))
                    for j, i in enumerate(sel, start=start)]
            out: List[Dict[str, np.ndarray]] = [f.result() for f in futs]
            num_valid = len(idxs)        # global count (pad_last semantics)
            local_target = stop - start
            if pad_last and len(out) < local_target:
                # short tail: pad to the static shape (an empty slice
                # borrows the batch's last sample as filler)
                filler = out[-1] if out else loader.load(int(idxs[-1]), None)
                out.extend([filler] * (local_target - len(out)))
            batch = _stack(out)
            if pad_last:
                batch["num_valid"] = np.asarray(num_valid, np.int32)
            return batch

        return load_batch

    # two pools: batch futures bound memory (prefetch_batches batches in
    # flight), the sample pool carries the decode parallelism; distinct
    # pools, so a batch worker waiting on sample futures cannot take the
    # threads those futures need
    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as sample_pool,\
         ThreadPoolExecutor(
             max_workers=max(prefetch_batches, 1)) as pool:
        load_batch = make_load_batch(sample_pool)
        futures: "queue.Queue" = queue.Queue()
        # the batch index keeps its absolute epoch position, so the
        # augmentation streams are the same with and without skip_batches
        it = iter(enumerate(batches, start=skip_batches))

        def submit_next() -> bool:
            try:
                args = next(it)
            except StopIteration:
                return False
            futures.put(pool.submit(load_batch, args))
            return True

        for _ in range(prefetch_batches):
            if not submit_next():
                break
        while not futures.empty():
            fut = futures.get()
            submit_next()
            yield fut.result()


# ---------------------------------------------------------------------------
# Host → device staging
# ---------------------------------------------------------------------------

def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``, on the current stream (a
    CPU device shares the arrays' memory)."""
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
        device, non_blocking=True) for k, v in batch.items()}


class DevicePrefetcher:
    """Keeps up to ``depth`` batches staged on ``device`` ahead of the
    consumer.

    A producer thread pulls numpy batches from ``batch_iter``, pins them and
    starts their host→device copies on a side stream, and records an event
    after each batch's copies. ``__next__`` makes the consumer's current
    stream wait on that event before it hands the batch out, and marks the
    batch's memory as used by that stream, so the allocator does not hand
    it to the side stream again while the consumer's kernels may still
    read it. On a CPU device the batches pass through as tensors sharing
    the arrays' memory."""

    def __init__(self, batch_iter: Iterator[Dict[str, np.ndarray]],
                 device, depth: int = 2):
        self._iter = batch_iter
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _stage(self, batch: Dict[str, np.ndarray]):
        if self._stream is None:
            return to_device(batch, self._device), None
        with torch.cuda.stream(self._stream):
            staged = to_device(batch, self._device)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return staged, ready

    def _fill(self) -> None:
        try:
            for batch in self._iter:
                item = self._stage(batch)
                while not self._stop:       # bounded put: close() can
                    try:                    # always unblock the producer
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
        except BaseException as e:          # noqa: BLE001 — re-raised below
            self._error = e
        finally:
            # the done sentinel must land on normal exhaustion even when
            # the queue is full; only a close() in progress may skip it
            while True:
                try:
                    self._q.put(self._done, timeout=0.2)
                    break
                except queue.Full:
                    if self._stop:
                        break

    def close(self) -> None:
        """Stop the producer and drop queued batches. Required when the
        consumer abandons iteration early (max_steps, preemption, a
        raising step): otherwise the producer blocks in put() forever,
        holding up to ``depth`` staged batches and the decode pools."""
        self._stop = True
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        close_iter = getattr(self._iter, "close", None)
        if close_iter is not None:
            close_iter()            # generator close → inner pools shut down

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                # a producer failure surfaces, not a silent short epoch
                raise self._error
            raise StopIteration
        staged, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in staged.values():
                t.record_stream(consumer)
        return staged

"""Host batching loader with threaded decode, and device prefetch.

Counterpart of superresolution_tpu/data/loader.py. `Loader` is the same
numpy loader (threads decode and stack, through a dataset's get_batch
when it has one; shuffling from seed + epoch; drop_last; pad_to_batch
with a `_valid` mask). `prefetch_to_device` keeps `size` batches in
flight to the card: each batch is copied from
pinned host memory with non_blocking=True on a side CUDA stream, and the
compute stream waits on that copy's event before it is handed out.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator

import numpy as np
import torch

from superresolution_tpu_torch.runtime import resolve_device


class Loader:
    """Iterates a map-style dataset into stacked numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, drop_last: bool = True,
                 pad_to_batch: bool = False):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.pad_to_batch = pad_to_batch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _fetch(self, idxs) -> dict[str, np.ndarray]:
        batch = None
        if hasattr(self.ds, "get_batch"):
            # the dataset's batch fast path (PairedDataset: the native TIFF
            # batch decoder); None -> the per-item path
            batch = self.ds.get_batch([int(i) for i in idxs])
        if batch is None:
            items = [self.ds[int(i)] for i in idxs]
            batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        n_items = len(idxs)
        if self.pad_to_batch and n_items < self.bs:
            pad = self.bs - n_items
            batch = {k: np.concatenate(
                [v, np.zeros((pad, *v.shape[1:]), v.dtype)])
                for k, v in batch.items()}
            batch["_valid"] = np.concatenate(
                [np.ones(n_items, np.bool_), np.zeros(pad, np.bool_)])
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        if self.drop_last:
            order = order[: (n // self.bs) * self.bs]
        idx_batches = [order[i:i + self.bs]
                       for i in range(0, len(order), self.bs)]
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque(
                pool.submit(self._fetch, idxs)
                for idxs in idx_batches[:self.num_workers])
            for idxs in idx_batches[self.num_workers:] + [None] * len(pending):
                fut = pending.popleft()
                if idxs is not None:
                    pending.append(pool.submit(self._fetch, idxs))
                yield fut.result()


def prefetch_to_device(iterator, size: int = 2,
                       device: str | torch.device | None = None):
    """Yield the batches of `iterator` (dicts of numpy arrays) as tensors
    on `device` (default cuda; raises without a GPU unless 'cpu'), with
    `size` batches already in flight."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        if side is None:
            return {k: torch.from_numpy(np.asarray(v)) for k, v in
                    batch.items()}, None
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(dev, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= size:
            break
    while queue:
        out, done = queue.popleft()
        for batch in it:
            queue.append(put(batch))
            break
        if done is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(done)
            for t in out.values():
                # memory allocated on the side stream, used on this one
                t.record_stream(compute)
        yield out

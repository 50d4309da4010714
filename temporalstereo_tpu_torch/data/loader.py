"""Batching data loader: background workers, per-sample seeds and shards.

Counterpart of the JAX package's ``data/loader.py``.  Two worker models,
which give the same batches:

  * ``use_processes=True``: a forkserver process pool; each worker builds
    one whole batch (decode, augment, collate) and sends it back.  The
    server starts from a clean process with ``CUDA_VISIBLE_DEVICES`` empty,
    so no worker inherits the parent's threads or can reach the card; the
    dataset is numpy only.  Without forkserver the loader uses threads,
    never a plain fork.
  * ``use_processes=False``: a thread pool.

An epoch's order is the dataset's, or a shuffle by ``RandomState(seed +
epoch)``.  With several shards each takes a strided slice; a shorter
shard is wrap-padded to the common length (an empty one from the whole
list) and ``pad_mask`` marks the duplicates with 0, so that evaluation
can leave them out.  Sample ``i`` of epoch ``e`` draws its augmentation
from the seed ``(seed + 100003 * e) * 131071 + i``, whatever the shard,
batch or worker.

``batch_to_device`` moves a numpy batch to the card (or, when asked, the
CPU) as tensors; ``prefetch_to_device`` keeps the next batches' copies in
flight while a step runs.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

# keys whose leading axis is time: collated to [T, B, ...]
TIME_MAJOR = ("left", "right", "disp_gt", "disp_gt_right", "T_cam", "inv_T")

# the dataset of a pool worker, set by _pool_init
_WORKER_DATASET = None


def _pool_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    os.environ["OMP_NUM_THREADS"] = "1"


def _assemble(dataset, idxs, pads, seeds) -> Dict[str, np.ndarray]:
    out = collate([dataset.getitem_seeded(int(i), int(s))
                   for i, s in zip(idxs, seeds)])
    # 1 = a real sample, 0 = a wrap-padded duplicate
    out["pad_mask"] = (~np.asarray(pads)).astype(np.float32)
    return out


def _pool_batch(args):
    """One whole batch, built inside a pool worker."""
    return _assemble(_WORKER_DATASET, *args)


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack samples into batch arrays; the time-major keys become
    [T, B, ...]."""
    out = {}
    for k in samples[0].keys():
        stacked = np.stack([s[k] for s in samples])
        if k in TIME_MAJOR:
            stacked = np.swapaxes(stacked, 0, 1)
        out[k] = np.ascontiguousarray(stacked)
    return out


def batch_to_device(batch: Dict[str, np.ndarray], device=None
                    ) -> Dict[str, torch.Tensor]:
    """A numpy batch -> tensors on ``device`` (the card by default; a
    missing card raises unless ``device="cpu"``)."""
    from ..models.builder import resolve_device

    device = resolve_device(device)
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Iterate ``(device_batch, host_batch)`` with ``size`` batches' copies
    to the card in flight ahead of the consumer (the JAX package's
    ``parallel/mesh.py:prefetch_to_device``).

    On the card each batch is pinned, copied ``non_blocking`` on a side
    stream, and the consumer's stream waits for that copy's event before
    the batch is yielded; ``record_stream`` keeps the caching allocator
    from reusing a batch's memory while the consumer's work on it is
    queued.  On the CPU it is ``batch_to_device``, one batch at a time.
    """
    from ..models import resolve_device

    device = resolve_device(device)
    if device.type != "cuda" or size <= 0:
        for host in iterator:
            yield batch_to_device(host, device), host
        return
    copies = torch.cuda.Stream(device)
    pending: deque = deque()
    it = iter(iterator)

    def enqueue() -> bool:
        host = next(it, None)
        if host is None:
            return False
        pinned = {k: torch.from_numpy(np.asarray(v)).pin_memory()
                  for k, v in host.items()}
        with torch.cuda.stream(copies):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(copies)
        pending.append((dev, host, done))
        return True

    for _ in range(size):
        if not enqueue():
            break
    while pending:
        dev, host, done = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in dev.values():
            t.record_stream(consumer)
        enqueue()
        yield dev, host


class DataLoader:
    """Batches of a dataset with ``getitem_seeded(idx, seed)`` (the
    ``StereoDataset`` interface)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 4,
                 seed: int = 43, num_shards: int = 1, shard_index: int = 0,
                 prefetch: int = 2, use_processes: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.use_processes = bool(
            use_processes and "forkserver" in mp.get_all_start_methods())
        self.epoch = 0
        self._pool = None

    def __len__(self) -> int:
        n = -(-len(self.dataset) // self.num_shards)   # the padded shard
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self):
        """-> (indices, is_pad) of this shard's epoch."""
        all_idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(all_idx)
        idx = all_idx[self.shard_index::self.num_shards]
        is_pad = np.zeros(len(idx), dtype=bool)
        if self.num_shards > 1:
            # every shard runs the same number of batches
            target = -(-len(self.dataset) // self.num_shards)
            if len(idx) < target:
                pad = np.resize(idx if len(idx) > 0 else all_idx,
                                target - len(idx))
                idx = np.concatenate([idx, pad])
                is_pad = np.concatenate([is_pad,
                                         np.ones(len(pad), dtype=bool)])
        if self.drop_last:
            keep = (len(idx) // self.batch_size) * self.batch_size
            idx, is_pad = idx[:keep], is_pad[:keep]
        return idx, is_pad

    def _batches(self):
        indices, is_pad = self._epoch_indices()
        epoch_seed = self.seed + 100003 * self.epoch
        seeds = np.asarray([epoch_seed * 131071 + int(i) for i in indices],
                           dtype=np.int64)
        self.epoch += 1
        return [(indices[i:i + self.batch_size],
                 is_pad[i:i + self.batch_size],
                 seeds[i:i + self.batch_size])
                for i in range(0, len(indices), self.batch_size)]

    # ------------------------------------------------------------ processes
    def _ensure_pool(self):
        if self._pool is None:
            ctx = mp.get_context("forkserver")
            saved = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                self._pool = ctx.Pool(self.num_workers,
                                      initializer=_pool_init,
                                      initargs=(self.dataset,))
            finally:
                if saved is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = saved
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _iter_processes(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = self._ensure_pool()
        batches = iter(self._batches())
        pending: deque = deque()

        def submit() -> bool:
            args = next(batches, None)
            if args is None:
                return False
            pending.append(pool.apply_async(_pool_batch, (args,)))
            return True

        # every worker busy, plus `prefetch` finished batches
        for _ in range(self.num_workers + self.prefetch):
            if not submit():
                break
        while pending:
            out = pending.popleft().get()
            submit()
            yield out

    # -------------------------------------------------------------- threads
    def _iter_threads(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs, pads, seeds in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(
                        lambda a: self.dataset.getitem_seeded(int(a[0]),
                                                              int(a[1])),
                        zip(idxs, seeds)))
                    out = collate(samples)
                    out["pad_mask"] = (~pads).astype(np.float32)
                    q.put(out)
            q.put(None)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.use_processes:
            return self._iter_processes()
        return self._iter_threads()

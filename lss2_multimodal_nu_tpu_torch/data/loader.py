"""Batched, prefetching data loader.

The JAX package's `data/loader.py` semantics: the index order
`default_rng(seed + epoch).shuffle` on train, a contiguous shard per host,
`drop_last` on both splits (the original repo's quirk, kept for metric
parity), worker seeds `13 + worker_id`, thread or process workers and
prefetch. It yields the JAX loader's batches, NCHW, as torch tensors on the
dataset's device.

The work is split in two stages (`data/dataset.py`). Workers run the host
stage of each item (file read, entropy decoding, augmentation draws,
labels); threads by default (the C++ entropy decoder releases the GIL), or
processes, which never touch CUDA. A producer thread collates each batch,
into pinned memory when the device is a card, and keeps the workers at most
`prefetch + 1` batches ahead of it; at most `prefetch` collated batches wait
for the consumer. The consumer runs the device stage (kernels 6 and 7) one
batch ahead on a side stream (`prefetch_to_device`), so that the next batch
is decoded while the current one trains.
"""
from __future__ import annotations

import collections
import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from .dataset import collate, device_stage

_WORKER_DS = None


def _worker_init(dataset, seed_base: int, counter):
    global _WORKER_DS
    _WORKER_DS = dataset
    # worker_init_fn of the original repo: numpy seeded with 13 + worker_id,
    # the ordinal from a shared counter
    with counter.get_lock():
        worker_id = counter.value
        counter.value += 1
    np.random.seed(seed_base + worker_id)


def _worker_get(i: int):
    return _WORKER_DS.host_item(i)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 13,
        host_shard: tuple = (0, 1),  # (host_index, host_count)
        prefetch: int = 2,
        worker_type: str = "thread",  # 'thread' | 'process'
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.host_index, self.host_count = host_shard
        self.prefetch = prefetch
        assert worker_type in ("thread", "process")
        self.worker_type = worker_type
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.host_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        per = n // self.host_count
        return idx[self.host_index * per : (self.host_index + 1) * per]

    def host_batches(self) -> "HostBatches":
        """One epoch of collated host batches (`data/dataset.py::collate`),
        in order, made by the workers and a producer thread."""
        idx = self._indices()
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        nb = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        if self.worker_type == "process":
            # never fork a process that may hold CUDA and threads: forkserver
            # (spawn where it is missing) starts workers from a clean process
            try:
                ctx = multiprocessing.get_context("forkserver")
            except ValueError:
                ctx = multiprocessing.get_context("spawn")
            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=ctx,
                initializer=_worker_init,
                initargs=(self.dataset, self.seed, ctx.Value("i", 0)),
            )
            submit = lambda i: pool.submit(_worker_get, i)  # noqa: E731
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            submit = lambda i: pool.submit(self.dataset.host_item, i)  # noqa: E731
        pin = self.dataset.device.type == "cuda"
        final_dim = self.dataset.aug.final_dim
        stop = threading.Event()

        def put(item) -> bool:
            """Queue item for the consumer; False once it has gone (the
            iterator closed), so that the producer ends rather than waits."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def submit_batch(b: int) -> list:
            return [submit(int(i)) for i in idx[b * self.batch_size : (b + 1) * self.batch_size]]

        def produce():
            # at most prefetch + 1 batches of items are in flight: batch
            # b + prefetch + 1 is submitted only once batch b is collated,
            # and a collated batch's items are dropped (an item holds its
            # cameras' coefficients, about 26 MB at 900x1600)
            try:
                ahead = min(nb, self.prefetch + 1)
                inflight = collections.deque(submit_batch(b) for b in range(ahead))
                following = ahead
                while inflight:
                    fs = inflight.popleft()
                    batch = collate([f.result() for f in fs], final_dim, pin=pin)
                    del fs
                    if following < nb:
                        inflight.append(submit_batch(following))
                        following += 1
                    if not put(batch):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(None)

        threading.Thread(target=produce, daemon=True).start()
        return HostBatches(out_q, stop, pool)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return prefetch_to_device(self.host_batches(), self.dataset.device)


class HostBatches:
    """One epoch's collated host batches, in order, as the producer thread
    queues them."""

    def __init__(self, out_q: "queue.Queue", stop: threading.Event, pool):
        self._q, self._stop, self._pool, self._done = out_q, stop, pool, False

    def __iter__(self) -> "HostBatches":
        return self

    def __next__(self) -> dict:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is None or isinstance(item, Exception):
            self.close()
            if item is None:
                raise StopIteration
            raise item  # a worker's or the producer's error
        return item

    def ready(self) -> bool:
        """Whether the next batch is there without waiting for it."""
        return self._done or not self._q.empty()

    def close(self):
        """End the epoch: the producer stops and the workers are dropped."""
        self._done = True
        self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    __del__ = close


def prefetch_to_device(host_batches: HostBatches, device) -> Iterator[Dict[str, torch.Tensor]]:
    """Run the device stage (`data/dataset.py::device_stage`) of each host
    batch on `device`. On a card it runs one batch ahead on a side stream:
    batch i + 1's copies and kernels are enqueued before batch i is handed
    out, if batch i + 1 is collated by then (it is never waited for), and
    the consumer's stream waits for a batch's event before it uses it (no
    host sync). On the CPU it runs in turn."""
    device = torch.device(device)
    try:
        if device.type != "cuda":
            for host in host_batches:
                yield device_stage(host, device)
            return
        side = torch.cuda.Stream(device)

        def stage(host):
            if host is None:
                return None
            with torch.cuda.stream(side):
                batch = device_stage(host, device)
                ready = torch.cuda.Event()
                ready.record(side)
            return batch, ready

        pending = None
        while True:
            current = pending or stage(next(host_batches, None))
            if current is None:
                return
            pending = stage(next(host_batches, None)) if host_batches.ready() else None
            yield _handed_over(*current, device)
    finally:
        host_batches.close()


def _handed_over(batch, ready, device):
    """`batch`, made on the side stream, for the current stream: it waits
    for `ready`, and the allocator learns that the tensors are used there."""
    stream = torch.cuda.current_stream(device)
    stream.wait_event(ready)
    for t in batch.values():
        t.record_stream(stream)
    return batch

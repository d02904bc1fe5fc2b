"""Threaded host loader and host-to-card prefetch (counterpart of
rcfd_tpu/data/loader.py ``DataLoader``, ``device_prefetch`` and
``iter_device_batches``).

The loader is a thread pool (the codec's zlib inflate and file reads
release the GIL) behind a bounded queue; batches are stacked numpy arrays
in the integer transport (uint8 images, uint16 streams). Each sample draws
from a Generator seeded by (seed, epoch, position), and the order of an
epoch is ``default_rng((seed, epoch)).permutation``, as in the JAX package:
the batches do not depend on the worker count and equal the JAX package's.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


class DataLoader:

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        """``batch_size`` is the global batch. Under data parallelism pass
        the rank and the world size as (``process_index``,
        ``process_count``): every rank builds the same global order (same
        seed and epoch) and yields its contiguous slice of each batch,
        whose samples draw from the Generators of their global positions,
        so that the slices equal the same rows of a one-process batch
        (rcfd_tpu/data/loader.py ``DataLoader``). A ragged last batch is
        dropped when ``drop_last`` or ``process_count`` > 1."""
        if batch_size % process_count:
            raise ValueError('the global batch size {} must divide by the '
                             'process count {}'.format(batch_size,
                                                       process_count))
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.start_batch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last or self.process_count > 1:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int, start_batch: int = 0):
        """The epoch of the next iteration, which yields its batches from
        ``start_batch`` on, counted in global batches (a run resumed
        inside an epoch)."""
        self.epoch = epoch
        self.start_batch = start_batch

    def _order(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return np.arange(n)

    def batches(self):
        """(first global position, sample indices) of this process's slice
        of each batch of the epoch."""
        order = self._order()
        local = self.batch_size // self.process_count
        lo = self.process_index * local
        out = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and \
                    (self.drop_last or self.process_count > 1):
                continue  # a ragged tail cannot be split evenly
            out.append((start + lo, idx[lo:lo + local]))
        return out

    def __iter__(self) -> Iterator:
        batches = self.batches()[self.start_batch:]

        def fetch_sample(pos, index):
            rng = np.random.default_rng((self.seed, self.epoch, int(pos)))
            return self.dataset.get(int(index), rng)

        def produce():
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                for start, idx in batches:
                    samples = list(ex.map(
                        fetch_sample, range(start, start + len(idx)), idx))
                    yield tuple(np.stack([s[i] for s in samples])
                                for i in range(len(samples[0])))

        yield from background(produce, self.prefetch)
        self.epoch += 1
        self.start_batch = 0


def background(produce, prefetch: int):
    """Yield the items of the generator ``produce()``, which runs in a
    thread, at most ``prefetch`` ahead of the consumer; an exception in
    it is raised here. Leaving early stops it after its current item."""
    out_q: 'queue.Queue' = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    end = object()

    def producer():
        items = produce()
        try:
            for item in items:
                out_q.put(item)
                if stop.is_set():
                    return
            out_q.put(end)
        except BaseException as e:  # surface the producer's errors
            out_q.put(e)
        finally:
            items.close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out_q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # let the producer see the stop
            try:
                out_q.get(timeout=0.1)
            except queue.Empty:
                pass


def device_prefetch(iterator, device, buffer_size: int = 2):
    """Host-to-card transfer ahead of use: each numpy batch is copied into
    pinned memory and sent with a non-blocking copy, ``buffer_size``
    batches ahead of the one yielded, so the copies overlap the host's wait
    for the card. Yields tuples of tensors on ``device`` in the transport
    dtypes (decode with ``transport.decode``). On the CPU the tensors are
    the arrays themselves."""
    device = torch.device(device)
    pending = collections.deque()

    def put(batch):
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == 'cuda':
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t)
        return tuple(out)

    for batch in iterator:
        pending.append(put(batch))
        if len(pending) >= buffer_size:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def iter_device_batches(dataset, batch_size: int, device, fields=None,
                        prefetch: int = 2):
    """The bulk-inference feeder of validation: yields (idxs, the host
    samples, the batch's tensors on ``device``) in order, while a thread
    reads the next batches and copies them to the device (pinned,
    non-blocking), ``prefetch`` ahead, so that the host's reads overlap the
    consumer's device work. The tail batch is padded by repeating its last
    sample, so that every batch has one shape; the consumer drops the
    padded outputs (``len(idxs)`` is the real count). ``fields`` picks the
    sample positions that are stacked and sent (all by default); the
    samples are yielded as the dataset made them, in the integer
    transport. The JAX package's optional s2d packing is a TPU layout
    rewrite and is not ported."""
    device = torch.device(device)
    n_sample = len(dataset)
    bsz = max(1, min(batch_size, n_sample))

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
        return t

    def produce():
        for start in range(0, n_sample, bsz):
            idxs = list(range(start, min(start + bsz, n_sample)))
            samples = [dataset.get(i) for i in idxs]
            padded = samples + [samples[-1]] * (bsz - len(samples))
            use = fields if fields is not None else range(len(padded[0]))
            yield idxs, samples, tuple(
                put(np.stack([s[j] for s in padded])) for j in use)

    return background(produce, prefetch)

"""Devices, ranks and the data-parallel train step (counterpart of
rcfd_tpu/parallel/mesh.py).

The JAX package's 1-D 'data' mesh becomes, in PyTorch's idiom:

- for serving, a list of devices in one process (``get_devices``):
  ``TwoStagePipeline.forward_sharded`` serves one contiguous slice of the
  batch on each, the models replicated;
- for training, a process group of one rank per card (``run_ranks``):
  every rank holds the parameters and Adam's state, takes its contiguous
  slice of the global batch and runs the same train step on it, and
  ``data_parallel_step`` averages the gradients, the floating batch-norm
  statistics and loss_info over the group before Adam, as the JAX step
  pmeans them under shard_map. Batch norm in training normalizes by each
  rank's own batch (no sync-BN), as each shard's does under shard_map.

The backend follows the device: NCCL for CUDA ranks, gloo on the CPU.
``run_ranks(..., shared_device=True)`` puts every rank on the one device
it is given, over gloo (NCCL refuses two ranks on one GPU): it checks the
sharded code on a machine with one card and shows nothing of scaling.

Across hosts the JAX package's environment contract holds
(``maybe_initialize_distributed``): one process a host, each starting its
local ranks; global rank = process id x local ranks + local rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue
import socket
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Optional

import torch
import torch.distributed as dist

from .. import default_device

# a collective's and the rendezvous' timeout: long enough for rank 0 to
# validate a whole split while the other ranks wait at a barrier
TIMEOUT = datetime.timedelta(hours=2)


@dataclasses.dataclass(frozen=True)
class HostLayout:
    """The hosts of a multi-host run: ``coordinator`` is host:port of
    process 0 (where global rank 0 listens), ``num_processes`` the host
    processes, ``process_id`` this one's."""
    coordinator: str
    num_processes: int
    process_id: int


def maybe_initialize_distributed() -> Optional[HostLayout]:
    """The multi-host layout the environment asks for, the JAX package's
    contract: RCFD_COORDINATOR (host:port of process 0),
    RCFD_NUM_PROCESSES and RCFD_PROCESS_ID, set per host process by its
    launcher. Returns None when RCFD_COORDINATOR is unset (one host). The
    process group itself is made by each rank that ``run_ranks`` starts."""
    coordinator = os.environ.get('RCFD_COORDINATOR')
    if coordinator is None:
        return None
    layout = HostLayout(coordinator, int(os.environ['RCFD_NUM_PROCESSES']),
                        int(os.environ['RCFD_PROCESS_ID']))
    if not 0 <= layout.process_id < layout.num_processes:
        raise ValueError('RCFD_PROCESS_ID={} is not in [0, '
                         'RCFD_NUM_PROCESSES={})'.format(
                             layout.process_id, layout.num_processes))
    return layout


def get_devices(n: Optional[int] = None, device=None):
    """The devices of sharded serving (JAX's ``get_mesh``): the first ``n``
    visible cards (all of them when ``n`` is None) as cuda:0 .. cuda:n-1,
    unless ``device='cpu'`` asks for the CPU: then ``n`` entries of cpu
    (one when ``n`` is None). More cards than are visible raises."""
    device = default_device(device)
    if device.type == 'cpu':
        return [device] * (1 if n is None else n)
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 0 < n <= count:
        raise ValueError('{} devices asked for; {} card(s) visible'.format(
            n, count))
    return [torch.device('cuda', i) for i in range(n)]


def shard_batch(batch, n: int):
    """The ``n`` contiguous slices, along the leading axis, of each array or
    tensor of ``batch``: a list of ``n`` tuples. The leading size must
    divide by ``n``."""
    size = len(batch[0])
    if size % n:
        raise ValueError('a batch of {} does not split into {} equal '
                         'shards'.format(size, n))
    s = size // n
    return [tuple(x[i * s:(i + 1) * s] for x in batch) for i in range(n)]


class ShardThreads:
    """One long-lived thread a shard slot: shard i of every sharded request
    runs on thread i (as ``torch.nn.parallel.parallel_apply`` runs a
    replica a thread, but kept). cuDNN keeps its autotuned convolution
    plans per thread, so a thread started for each request autotunes every
    convolution again, for tens of seconds a request at full width; a kept
    thread autotunes once, and a slot's shard takes the same algorithms
    from request to request. The threads are daemons that wait on their
    queues."""

    def __init__(self, n: int):
        self.queues = [queue.SimpleQueue() for _ in range(n)]
        for q in self.queues:
            threading.Thread(target=self._work, args=(q,),
                             daemon=True).start()

    @staticmethod
    def _work(q):
        while True:
            future, fn, args = q.get()
            try:
                future.set_result(fn(*args))
            except BaseException as e:  # handed to the caller
                future.set_exception(e)

    def submit(self, i: int, fn, *args) -> Future:
        """``fn(*args)`` on thread i, after what it already holds: its
        future."""
        future = Future()
        self.queues[i].put((future, fn, args))
        return future

    def map(self, fn, shard_args):
        """``[fn(*args) for args in shard_args]``, shard i on thread i, all
        at once; raises the first shard's exception after every shard
        ends."""
        futures = [self.submit(i, fn, *args)
                   for i, args in enumerate(shard_args)]
        for f in futures:
            f.exception()  # waits for the shard
        return [f.result() for f in futures]


_SHARD_THREADS = {}
_SHARD_THREADS_LOCK = threading.Lock()


def shard_threads(n: int) -> ShardThreads:
    """The process's ``ShardThreads`` of ``n`` slots, made at first use and
    shared by every pipeline, so that every request's shard i finds thread
    i's plans."""
    with _SHARD_THREADS_LOCK:
        if n not in _SHARD_THREADS:
            _SHARD_THREADS[n] = ShardThreads(n)
        return _SHARD_THREADS[n]


def world_size() -> int:
    """The ranks of the process group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's global rank, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_lead() -> bool:
    """Whether this process writes summaries and checkpoints (rank 0)."""
    return rank() == 0


def barrier():
    """Wait for every rank (nothing without a group)."""
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def process_group(backend: str, address: str, world: int, rank: int,
                  device=None):
    """The default process group for the body, destroyed on exit. NCCL is
    bound to ``device`` at once, so that a group that cannot start fails
    here."""
    dist.init_process_group(
        backend, init_method=address, world_size=world, rank=rank,
        timeout=TIMEOUT,
        device_id=torch.device(device) if backend == 'nccl' else None)
    try:
        yield
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A localhost TCP port that no socket holds now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(fn, args, world: int, device, shared_device: bool = False,
              layout: Optional[HostLayout] = None):
    """Run ``fn(rank_device, *args)`` on each of this host's ranks of a
    process group of ``world`` ranks and return their results in local-rank
    order. ``fn`` and ``args`` are pickled (``fn`` by import path), and so
    is each result.

    Local rank r runs on cuda:r, or on the CPU for a CPU ``device``, or on
    ``device`` itself with ``shared_device``. One host (``layout`` None):
    ``world`` ranks on a free localhost port. Several (``layout``, from
    ``maybe_initialize_distributed``): world / num_processes ranks here,
    global rank 0 listening at the coordinator. The ranks are processes
    started with ``spawn`` (CUDA cannot fork), or this process itself when
    it has one rank. A rank that raises or dies fails the call with its
    traceback or exit code, after the other ranks are stopped; the error
    holds the traceback of every rank that raised, the first to raise
    first, so that a rank's own fault leads the broken collectives it
    leaves the others in."""
    device = torch.device(device)
    hosts = 1 if layout is None else layout.num_processes
    if world % hosts:
        raise ValueError('{} ranks do not split over {} hosts'.format(
            world, hosts))
    n_local = world // hosts
    first = 0 if layout is None else layout.process_id * n_local
    address = 'tcp://' + (layout.coordinator if layout is not None else
                          '127.0.0.1:{}'.format(free_port()))
    backend = 'nccl' if device.type == 'cuda' and not shared_device \
        else 'gloo'
    with tempfile.TemporaryDirectory(prefix='rcfd-ranks-') as out:
        spec = (fn, args, str(device), shared_device, backend, address,
                world, first, out, torch.get_num_threads())
        if n_local == 1:
            _rank_entry(0, *spec)
        else:
            try:
                torch.multiprocessing.start_processes(
                    _rank_entry, args=spec, nprocs=n_local, join=True,
                    start_method='spawn')
            except Exception as e:
                raised = []
                for r in range(n_local):
                    path = os.path.join(out, 'rank-{}.err'.format(r))
                    if os.path.exists(path):
                        with open(path, 'rb') as f:
                            raised.append(pickle.load(f) + (first + r,))
                if not raised:
                    raise
                raise RuntimeError('\n'.join(
                    'rank {} raised:\n{}'.format(r, text)
                    for _, text, r in sorted(raised))) from e  # first first
        results = []
        for r in range(n_local):
            with open(os.path.join(out, 'rank-{}.pkl'.format(r)), 'rb') as f:
                results.append(pickle.load(f))
    return results


def _rank_entry(local_rank, fn, args, device, shared_device, backend,
                address, world, first, out, threads):
    """One rank of ``run_ranks``: its device, its group, ``fn``, and its
    result written for the caller."""
    torch.set_num_threads(threads)
    device = torch.device(device)
    if device.type == 'cuda':
        index = (device.index if device.index is not None else 0) \
            if shared_device else local_rank
        device = torch.device('cuda', index)
        torch.cuda.set_device(device)
    with process_group(backend, address, world, first + local_rank, device):
        try:
            result = fn(device, *args)
        except BaseException:
            # written before the group's connections close, so the caller
            # finds it whichever rank fails first
            with open(os.path.join(out, 'rank-{}.err'.format(local_rank)),
                      'wb') as f:
                pickle.dump((time.monotonic_ns(), traceback.format_exc()), f)
            raise
    with open(os.path.join(out, 'rank-{}.pkl'.format(local_rank)),
              'wb') as f:
        pickle.dump(result, f)


def all_reduce_mean(tensors):
    """Replace each tensor by its mean over the ranks, in place: a SUM
    all-reduce, then a division by the world size (gloo has no AVG; JAX's
    pmean is the psum over n), in one flat buffer per dtype and device.
    Returns ``tensors``."""
    world = torch.tensor(float(dist.get_world_size()))
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for (dtype, dev), ts in buckets.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        # a division by a tensor, a true division on the card too
        flat.div_(world.to(dev, dtype))
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


class _DataParallelStep:
    """The step ``data_parallel_step`` returns."""

    def __init__(self, step):
        self.step = step

    def __getattr__(self, name):
        return getattr(self.__dict__['step'], name)

    def backward(self, batch, draws):
        loss_info = self.step.backward(batch, draws)
        model = self.step.model
        device = next(model.parameters()).device
        names = list(loss_info)
        values = [torch.as_tensor(loss_info[k], device=device).clone()
                  for k in names]
        all_reduce_mean(
            [p.grad for p in model.parameters() if p.grad is not None] +
            [b for b in model.buffers() if b.is_floating_point()] + values)
        return dict(zip(names, values))

    def __call__(self, batch, draws, learning_rate: float):
        loss_info = self.backward(batch, draws)
        self.step.update(learning_rate)
        return loss_info


def data_parallel_step(step):
    """An ``OptimizerStep`` (rcfd_tpu_torch/training.py) under the JAX
    package's data-parallel rules (rcfd_tpu/parallel/mesh.py
    ``data_parallel_step`` over the drivers' ``_make_train_step`` with an
    ``axis_name``): each rank's backward on its slice of the batch, then,
    before Adam, the gradients, the floating batch-norm buffers (running
    statistics; the integer batch counts are left alone) and loss_info
    averaged over the default group. Adam then takes the same step on every
    rank, so the replicated parameters stay equal. Not DDP: its default
    buffer broadcast would copy rank 0's running statistics where JAX
    averages them. The wrapped step's other attributes pass through."""
    return _DataParallelStep(step)


def broadcast_module(module):
    """Copy rank 0's parameters and buffers into every rank's ``module``."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t, 0)


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]

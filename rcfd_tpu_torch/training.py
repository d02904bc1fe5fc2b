"""What the port's two training loops share (``fusionnet_main.train`` and
``radarnet_main.train``): the numerics and the training dtype, the
refusals, the data-parallel count and the launch of its ranks, Adam, the
seed of a step's augmentation draws, the optimizer step around a model's
loss, the walk over the schedules' epochs and their batches, and eval mode
for validation.

A run restored at step s skips the s steps it has done (the epochs before
step s, and the first batches of the epoch it stops in) and ends at the
schedule's last step, as a resumed run should; the JAX training loops run
the whole schedule again from step s. Since each batch is a function of
(seed, epoch, position) and each step's augmentation of (seed, step), the
resumed run feeds and draws what an uninterrupted run would.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from . import parallel
from .data import raw_cache


@contextlib.contextmanager
def training_numerics():
    """The numerics of training, restored on exit: TF32 off for
    convolutions and matmuls (as in serving) and cuDNN algorithms
    chosen by timing at the first step of each shape. Unlike serving,
    cuDNN may choose nondeterministic backward algorithms (atomics), which
    are faster; two runs then differ in the last bits of the gradients."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
             matmul.allow_tf32)
    cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = True, False, False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         matmul.allow_tf32) = saved


@contextlib.contextmanager
def eval_mode(model):
    """The model in eval mode (batch norm by its running statistics), its
    mode restored on exit: the validation forwards of both trainings."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def train_dtype():
    """The dtype the network's inputs are cast to in training, from
    RCFD_TRAIN_DTYPE as the JAX package reads it: None (no cast: the
    parameters' dtype, float32) when it is unset, '' or 'float32';
    torch.bfloat16 for 'bfloat16', mixed precision (the layers compute in
    bf16 from bf16 copies of the float32 master weights; the optimizer
    state, labels and losses stay float32). Any other value raises
    ValueError."""
    value = os.environ.get('RCFD_TRAIN_DTYPE', '')
    if value in ('', 'float32'):
        return None
    if value == 'bfloat16':
        return torch.bfloat16
    raise ValueError('RCFD_TRAIN_DTYPE={}: rcfd_tpu_torch trains in float32 '
                     "('' or 'float32') or bf16 ('bfloat16')".format(value))


def numerics_line(dtype=None) -> str:
    """The numerics of a training run, with ``dtype`` ``train_dtype()``'s,
    in one line."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    what = 'float32' if dtype is None else (
        'bf16 network inputs and activations, float32 master weights, '
        'optimizer state and losses (RCFD_TRAIN_DTYPE=bfloat16)')
    return ('Numerics: {}, TF32 {} for convolutions and {} for matmuls; '
            'cuDNN benchmark {}, deterministic {}'.format(
                what, 'on' if cudnn.allow_tf32 else 'off',
                'on' if matmul.allow_tf32 else 'off', cudnn.benchmark,
                cudnn.deterministic))


def refuse_unported(device):
    """Raise ValueError for what the JAX training loops do and the port
    does not: a TPU; and for a training dtype other than float32 and bf16
    (``train_dtype``)."""
    if str(device).lower() == 'tpu':
        raise ValueError("device 'tpu': rcfd_tpu_torch trains on a CUDA "
                         "device ('cuda') or the CPU ('cpu')")
    train_dtype()


def data_parallel_count(device, n_data_parallel, batch_size: int,
                        layout=None) -> int:
    """The ranks a training runs on, the JAX package's ``n_devices =
    n_data_parallel or jax.device_count()``: inside a process group its
    size; else ``n_data_parallel``, or when it is None every visible card
    of every host (``layout``, ``parallel.maybe_initialize_distributed``'s)
    on CUDA and one rank a host on the CPU. Raises ValueError where JAX
    asserts: a ``batch_size`` (global) that the count does not divide; and
    for more ranks than the hosts' visible cards on CUDA or a count that
    does not split evenly over the hosts."""
    if parallel.world_size() > 1:
        n = parallel.world_size()
    else:
        device = torch.device(device)
        hosts = 1 if layout is None else layout.num_processes
        local = torch.cuda.device_count() if device.type == 'cuda' else 1
        n = n_data_parallel or local * hosts
        if n < 1:
            raise ValueError('n_data_parallel={}: train on 1 or more '
                             'ranks'.format(n_data_parallel))
        if n % hosts:
            raise ValueError('n_data_parallel={} does not split over {} '
                             'hosts'.format(n, hosts))
        if device.type == 'cuda' and n > local * hosts:
            raise ValueError(
                'n_data_parallel={}: {} card(s) visible on each of {} '
                'host(s)'.format(n, local, hosts))
    if batch_size % n:
        raise ValueError(
            'n_data_parallel={}: batch_size ({}) must divide by the '
            'data-parallel count'.format(n, batch_size))
    return n


def launch_ranks(train_fn, arguments: dict, world: int, device,
                 layout=None):
    """Run ``train_fn(**arguments)`` (a training loop that finds itself in
    a process group and takes its part) on this host's ranks of a group of
    ``world`` (``parallel.run_ranks``), with this process's raw-cache
    directory. ``arguments['timings']``, a list, receives every local
    rank's step entries, each with its ``rank``. Returns the best
    validation results, which every rank returns alike."""
    timings = arguments.get('timings')
    results = parallel.run_ranks(
        _train_rank, (train_fn, dict(arguments, timings=None),
                      raw_cache.cache_dir()),
        world, device, layout=layout)
    if timings is not None:
        for _, rank_timings in results:
            timings.extend(rank_timings)
    return results[0][0]


def _train_rank(device, train_fn, arguments, cache_dir):
    """One rank of ``launch_ranks``: (best results, its step entries)."""
    timings = []
    with raw_cache.raw_cache_for(cache_dir):
        best = train_fn(**dict(arguments, device=device, timings=timings))
    for entry in timings:
        entry['rank'] = parallel.rank()
    return best, timings


def quiet(*args, **kwargs):
    """``log`` on a data-parallel rank other than 0: nothing (rank 0 logs
    for the run)."""


def step_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s augmentation draws: a function of
    (seed, step) alone, so that a restored run draws what an uninterrupted
    run draws at the same step."""
    return int(np.random.SeedSequence((seed, step)).generate_state(
        1, np.uint64)[0]) >> 1


def make_optimizer(model, learning_rate: float, weight_decay: float):
    """Adam as the reference configures it (src/fusionnet_main.py:307-312,
    src/radarnet_main.py): betas (0.9, 0.999), eps 1e-8, L2 weight decay
    (added to the gradient, the JAX package's ``adam_step``)."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


class OptimizerStep:
    """One optimizer step of a model on a batch. A subclass sets
    ``self.optimizer`` and defines ``loss(batch, draws)`` -> (loss,
    loss_info)."""

    def backward(self, batch, draws):
        """The loss and its gradients in the parameters' ``.grad``; returns
        loss_info with detached values."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, loss_info = self.loss(batch, draws)
        loss.backward()
        return {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
                for k, v in loss_info.items()}

    def update(self, learning_rate: float):
        """Adam's step at ``learning_rate`` on the gradients in ``.grad``."""
        for group in self.optimizer.param_groups:
            group['lr'] = learning_rate
        self.optimizer.step()

    def __call__(self, batch, draws, learning_rate: float):
        loss_info = self.backward(batch, draws)
        self.update(learning_rate)
        return loss_info


def epochs(learning_rates, learning_schedule, augmentation_probabilities,
           augmentation_schedule, done: int, steps_per_epoch: int):
    """The epochs of the schedules that have steps left after ``done``
    restored ones: yields (epoch, its first batch, learning rate,
    augmentation probability). The rate moves to the next of
    ``learning_rates`` after each epoch of ``learning_schedule``, the
    probability likewise unless ``augmentation_schedule`` holds -1."""
    learning_schedule_pos = 0
    augmentation_schedule_pos = 0
    learning_rate = learning_rates[0]
    augmentation_probability = augmentation_probabilities[0]
    for epoch in range(1, learning_schedule[-1] + 1):
        if epoch > learning_schedule[learning_schedule_pos]:
            learning_schedule_pos += 1
            learning_rate = learning_rates[learning_schedule_pos]
        if -1 not in augmentation_schedule and \
                epoch > augmentation_schedule[augmentation_schedule_pos]:
            augmentation_schedule_pos += 1
            augmentation_probability = \
                augmentation_probabilities[augmentation_schedule_pos]
        skip = min(done - (epoch - 1) * steps_per_epoch, steps_per_epoch)
        if skip >= steps_per_epoch:
            continue  # an epoch the restored run has done
        yield epoch, max(skip, 0), learning_rate, augmentation_probability


def timed(batches):
    """Yields (batch, the host's wait for it in ms, the clock at the wait's
    start) for each batch of the iterator ``batches``."""
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            return
        yield batch, (time.perf_counter() - t0) * 1e3, t0


def step_timing(device, step: int, t0: float, wait_ms: float, loss) -> dict:
    """A step's entry of ``timings``: its milliseconds from the clock at
    its wait's start (the card synchronized first, which it then is every
    step), less the wait, and the loss; on a card also this process's peak
    of allocated memory so far (``peak_bytes``)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    entry = dict(step=step, wait_ms=wait_ms,
                 step_ms=(time.perf_counter() - t0) * 1e3 - wait_ms,
                 loss=float(loss))
    if device.type == 'cuda':
        entry['peak_bytes'] = torch.cuda.max_memory_allocated(device)
    return entry

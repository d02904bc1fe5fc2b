"""Rank functions of tests/test_torch_parallel*.py. They run in the gloo
ranks that rcfd_tpu_torch.parallel.run_ranks spawns on the CPU, which
import them by module path, so this module imports no JAX."""

import importlib
import os
import sys
import types

import torch

from rcfd_tpu_torch import fusionnet_main, parallel, radarnet_main
from rcfd_tpu_torch.data.transforms import Transforms
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel

MODELS = {'fusionnet': (FusionNetModel, fusionnet_main),
          'radarnet': (RadarNetModel, radarnet_main)}


def step_cases(device, cases):
    """One data-parallel train step in float64 of each case on this rank's
    contiguous slice of the case's batch: each case a dict of 'kind'
    ('fusionnet' or 'radarnet'), 'config' (the model's), 'state_dict',
    'transforms' (Transforms' keywords), 'step' (the TrainStep's
    keywords), 'batch' (numpy arrays, the global batch), 'draws' (for the
    local batch) and 'lr'. Returns per case the averaged loss_info, the
    averaged gradients, the parameters after Adam and the buffers."""
    out = []
    for case in cases:
        model_cls, main = MODELS[case['kind']]
        model = model_cls(**case['config'], device='cpu', trainable=True)
        model.load_state_dict(case['state_dict'], strict=True)
        model = model.to(device, torch.float64)
        step = parallel.data_parallel_step(main.TrainStep(
            model, Transforms(**case['transforms']),
            main.make_optimizer(model, case['lr'], 0.0), **case['step']))
        local = parallel.shard_batch(case['batch'], parallel.world_size())[
            parallel.rank()]
        info = step(tuple(torch.from_numpy(a).to(device) for a in local),
                    {k: v.to(device) for k, v in case['draws'].items()},
                    case['lr'])
        out.append(dict(
            info={k: float(v) for k, v in info.items()},
            grads={n: p.grad.cpu().numpy()
                   for n, p in model.named_parameters()
                   if p.grad is not None},
            params={n: p.detach().cpu().numpy()
                    for n, p in model.named_parameters()},
            buffers={n: b.cpu().numpy() for n, b in model.named_buffers()}))
    return out


def without_tensorflow():
    """tensorboard's own switch to its TensorFlow stub (a module
    tensorboard.compat.notf): a fresh process that writes summaries then
    does not import TensorFlow, where it is installed (seconds a
    process); the event files are the same."""
    sys.modules.setdefault('tensorboard.compat.notf',
                           types.ModuleType('tensorboard.compat.notf'))


def recorded_train(device, kind, call):
    """``<kind>_main.train(**call)`` for a dict, or the CLI
    ``train_<kind>.main(call)`` for a list of flags, as this rank's part of
    the group, recording the augmentation draws it takes (the batch size
    asked for and the draws) and the checkpoints it writes. Returns (the
    best results, the draws, the checkpoint names, the step entries)."""
    without_tensorflow()
    model_cls, main = MODELS[kind]
    drawn, saved = [], []
    draws, save = Transforms.draws, model_cls.save_checkpoint

    def recording_draws(self, generator, n_batch, *args):
        d = draws(self, generator, n_batch, *args)
        drawn.append((n_batch, {k: v.clone() for k, v in d.items()}))
        return d

    def recording_save(self, path, *args, **kw):
        saved.append(os.path.basename(path))
        return save(self, path, *args, **kw)

    Transforms.draws, model_cls.save_checkpoint = recording_draws, \
        recording_save
    try:
        timings = []
        if isinstance(call, dict):
            best = main.train(**dict(call, device=device, timings=timings))
        else:
            best = importlib.import_module(
                'rcfd_tpu_torch.train_' + kind).main(
                    call, device=device, timings=timings)
    finally:
        Transforms.draws, model_cls.save_checkpoint = draws, save
    return best, drawn, saved, timings


def gathered(device, n):
    """Each rank's rank, world size and the mean of (rank + 1) * ones(n)
    over the group (``all_reduce_mean``), and the lead's object as every
    rank receives it."""
    t = torch.full((n,), float(parallel.rank() + 1), device=device)
    parallel.all_reduce_mean([t])
    return (parallel.rank(), parallel.world_size(), t.cpu().numpy(),
            parallel.broadcast_object({'from': parallel.rank()}))


def raises_on_rank_1(device, wait):
    """Rank 1 raises; rank 0 returns, or with ``wait`` waits for rank 1 at
    a barrier that rank 1 never reaches."""
    if parallel.rank() == 1:
        raise RuntimeError('rank 1 fails on purpose')
    if wait:
        parallel.barrier()
    return parallel.rank()

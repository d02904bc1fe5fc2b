"""Rank functions of tests/test_torch_gspmd.py. They run in the gloo ranks
that rcfd_tpu_torch.parallel.run_ranks spawns on the CPU, which import
them by module path, so this module imports no JAX."""

import os

import numpy as np
import torch

from rcfd_tpu_torch import fusionnet_main, parallel
from rcfd_tpu_torch.data.transforms import Transforms
from rcfd_tpu_torch.models import FusionNetModel

DTYPES = {'float32': torch.float32, 'float64': torch.float64}


def port_step(model, case):
    """The port's single-process TrainStep of ``case`` on ``model``, built
    with the case's RCFD_TRAIN_DTYPE."""
    saved = os.environ.get('RCFD_TRAIN_DTYPE')
    os.environ['RCFD_TRAIN_DTYPE'] = case.get('train_dtype', '')
    try:
        return fusionnet_main.TrainStep(
            model, Transforms(**case['transforms']),
            fusionnet_main.make_optimizer(model, case['lr'], 0.0),
            **case['step'])
    finally:
        if saved is None:
            del os.environ['RCFD_TRAIN_DTYPE']
        else:
            os.environ['RCFD_TRAIN_DTYPE'] = saved


def port_model(case, device='cpu'):
    model = FusionNetModel(**case['config'], device='cpu', trainable=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           case['state_dict'].items()}, strict=True)
    return model.to(device, DTYPES[case['dtype']])


def results(model, info, exchanged=None):
    """loss_info, the gradients, the parameters and the buffers, copied to
    the host (on the CPU ``.numpy()`` shares the tensor's memory)."""
    return dict(
        info={k: float(v) for k, v in info.items()},
        grads={n: p.grad.cpu().numpy().copy()
               for n, p in model.named_parameters() if p.grad is not None},
        params={n: p.detach().cpu().numpy().copy()
                for n, p in model.named_parameters()},
        buffers={n: b.cpu().numpy().copy() for n, b in model.named_buffers()},
        exchanged=exchanged)


def run_case(device, case):
    """One step of ``case`` on the mesh of the group's first n_data x
    n_spatial ranks. ``case`` is a dict: 'mesh' (n_data, n_spatial),
    'config', 'state_dict' (numpy arrays), 'dtype', 'transforms', 'step'
    (TrainStep's keywords), 'train_dtype', 'batch' (global numpy arrays),
    'draws' (the global batch's, numpy arrays), 'lr', 'adam' (Adam's step
    after the backward, or the backward alone). Returns this rank's
    ``results``, or None outside the mesh."""
    n_data, n_spatial = case['mesh']
    size = n_data * n_spatial
    mesh = parallel.get_mesh_2d(
        n_data, n_spatial,
        None if size == parallel.world_size() else range(size))
    if mesh is None:
        return None
    model = port_model(case, device)
    step = parallel.gspmd_train_step(port_step(model, case), mesh)
    local = parallel.shard_batch_2d(mesh, case['batch'])
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in local)
    draws = {k: torch.from_numpy(v).to(device)
             for k, v in case['draws'].items()}
    if case['adam']:
        info = step(batch, draws, case['lr'])
    else:
        info = step.backward(batch, draws)
    return results(model, info, dict(mesh.exchanged))


def mesh_cases(device, cases, threads=1):
    """``run_case`` of each case in turn, then the refusals of a mesh of
    another size than the group: (results per case, the messages)."""
    torch.set_num_threads(threads)
    out = [run_case(device, case) for case in cases]
    refused = []
    for shape, ranks in (((3, 2), None), ((2, 2), range(3))):
        try:
            parallel.get_mesh_2d(*shape, ranks)
        except ValueError as e:
            refused.append(str(e))
    return out, refused

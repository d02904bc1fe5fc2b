"""Training on a 2-D (data x spatial) mesh (counterpart of
rcfd_tpu/parallel/gspmd.py): the batch split over a 'data' axis and each
frame's rows over a 'spatial' axis, with the single-device step's
semantics.

The JAX package runs the single-device train step under jit with the
batch sharded over such a mesh and lets GSPMD partition it: convolutions
exchange halos, batch norm reduces over the whole global batch (sync-BN)
and the gradients are those of the global loss. For frames as large as
nuScenes' 900x1600 this is how training scales past the point where one
sample's activations fill a device. PyTorch has no GSPMD, so the port
shards the rows by hand (parallel/spatial.py): each rank of a process
group of n_data x n_spatial ranks (``parallel.run_ranks``) runs FusionNet's
step on its block, and one call gives the loss, loss_info, gradients,
running statistics and Adam step that one process gets on the whole
batch, up to the order of the sums. Parameters and Adam's state are
replicated and stay equal on every rank.

Unlike ``parallel.data_parallel_step`` (the JAX package's shard_map
semantics: each rank's own batch-norm statistics, losses and gradients
averaged) nothing here is averaged: batch norm uses global sums, and the
gradients of each rank's share of the global loss are SUMMED over the
mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .spatial import Mesh2D, sum_gradients, train_loss


def get_mesh_2d(n_data: int, n_spatial: int, ranks=None):
    """This rank's place in a 2-D mesh of the default process group, or of
    the global ``ranks`` of it (in mesh order): rank r of the mesh is at
    (data r // n_spatial, spatial r % n_spatial). Every rank of the default
    group calls it, since it makes the mesh's process groups (the whole
    mesh, each spatial row, each data column) in one order on every rank;
    a rank outside ``ranks`` gets None. Raises ValueError when the mesh is
    not n_data x n_spatial ranks, with the JAX function's message."""
    if not dist.is_initialized():
        raise RuntimeError('get_mesh_2d runs in a process group '
                           '(parallel.run_ranks)')
    members = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    if len(members) != n_data * n_spatial:
        raise ValueError('need {} devices, have {}'.format(
            n_data * n_spatial, len(members)))
    group = dist.group.WORLD if ranks is None else dist.new_group(members)
    rows = [dist.new_group(members[d * n_spatial:(d + 1) * n_spatial])
            for d in range(n_data)]
    columns = [dist.new_group(members[s::n_spatial])
               for s in range(n_spatial)]
    me = dist.get_rank()
    if me not in members:
        return None
    d, s = divmod(members.index(me), n_spatial)
    return Mesh2D(n_data, n_spatial, d, s, group, rows[d], columns[s])


def shard_batch_2d(mesh: Mesh2D, batch):
    """This rank's block of each (N, H, ...) array or tensor of ``batch``:
    N over 'data' (contiguous, equal shares), H over 'spatial'
    (``spatial.split_rows``), as JAX's P('data', 'spatial') places them."""
    n, h = batch[0].shape[0], batch[0].shape[1]
    if n % mesh.n_data or any(x.shape[:2] != batch[0].shape[:2]
                              for x in batch):
        raise ValueError('a batch of {} does not split into {} equal data '
                         'shards of arrays of one (N, H)'.format(
                             n, mesh.n_data))
    s = n // mesh.n_data
    d = mesh.data_index
    a, b = mesh.rows(h)
    return tuple(x[d * s:(d + 1) * s, a:b] for x in batch)


class _GSPMDStep:
    """The step ``gspmd_train_step`` returns."""

    def __init__(self, step, mesh):
        self.step = step
        self.mesh = mesh

    def __getattr__(self, name):
        return getattr(self.__dict__['step'], name)

    def height(self, rows: int) -> int:
        """The global height of a batch whose block has ``rows`` rows."""
        mesh = self.mesh
        t = torch.tensor([rows], device=next(
            self.step.model.parameters()).device)
        dist.all_reduce(t, group=mesh.spatial_group)
        h = int(t.item())
        a, b = mesh.rows(h)
        if b - a != rows:
            raise ValueError('a block of {} rows is not spatial shard {} of '
                             '{} rows (shard_batch_2d)'.format(
                                 rows, mesh.spatial_index, h))
        return h

    def backward(self, batch, draws):
        """This rank's block of the batch (``shard_batch_2d``) and the
        global batch's draws: the global loss's gradients in every
        parameter's ``.grad`` (the same on every rank); returns loss_info,
        the global values."""
        step, mesh = self.step, self.mesh
        h = self.height(batch[0].shape[1])
        n = batch[0].shape[0]
        lo = mesh.data_index * n
        for k, v in draws.items():
            if v.shape[0] != n * mesh.n_data:
                raise ValueError('draws[{!r}] is for {} samples, not the '
                                 'global batch of {}'.format(
                                     k, v.shape[0], n * mesh.n_data))
        draws = {k: v[lo:lo + n] for k, v in draws.items()}
        step.optimizer.zero_grad(set_to_none=True)
        loss, loss_info = train_loss(mesh, step, batch, draws, h)
        (loss / mesh.size).backward()
        sum_gradients(mesh, step.model.parameters())
        return {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
                for k, v in loss_info.items()}

    def __call__(self, batch, draws, learning_rate: float):
        loss_info = self.backward(batch, draws)
        self.step.update(learning_rate)
        return loss_info


def gspmd_train_step(step, mesh: Mesh2D):
    """A ``fusionnet_main.TrainStep`` over ``mesh`` (``get_mesh_2d``):
    called on every rank of the mesh with its block of the batch
    (``shard_batch_2d``), the global batch's augmentation draws (the same
    on every rank) and the learning rate, it takes the single-device step
    on the whole batch: the backward of each rank's share of the global
    loss (batch norm over the global batch, halos exchanged), the
    gradients SUMMED over the mesh, then Adam on every rank alike. Returns
    loss_info. ``backward`` alone leaves the summed gradients in
    ``.grad``; the step's other attributes pass through."""
    return _GSPMDStep(step, mesh)

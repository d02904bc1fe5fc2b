"""Data parallelism (counterpart of rcfd_tpu/parallel/mesh.py): the device
list of sharded serving, the ranks of data-parallel training and their
launch, the gradient and batch-norm averaging of a train step; and the
2-D (data x spatial) mesh of FusionNet training (counterpart of
rcfd_tpu/parallel/gspmd.py): the batch over 'data', each frame's rows over
'spatial', with the single-device step's semantics."""

from .gspmd import get_mesh_2d, gspmd_train_step, shard_batch_2d
from .mesh import (HostLayout, ShardThreads,
                   all_reduce_mean, barrier, broadcast_module,
                   broadcast_object, data_parallel_step, free_port,
                   get_devices, is_lead, maybe_initialize_distributed,
                   process_group, rank, run_ranks, shard_batch,
                   shard_threads, world_size)
from .spatial import Mesh2D, split_rows

__all__ = ['HostLayout', 'Mesh2D', 'ShardThreads',
           'all_reduce_mean', 'barrier', 'broadcast_module',
           'broadcast_object', 'data_parallel_step', 'free_port',
           'get_devices', 'get_mesh_2d', 'gspmd_train_step', 'is_lead',
           'maybe_initialize_distributed', 'process_group', 'rank',
           'run_ranks', 'shard_batch', 'shard_batch_2d', 'shard_threads',
           'split_rows', 'world_size']

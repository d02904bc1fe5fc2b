"""Data parallelism (counterpart of rcfd_tpu/parallel/mesh.py): the device
list of sharded serving, the ranks of data-parallel training and their
launch, the gradient and batch-norm averaging of a train step."""

from .mesh import (HostLayout, ShardThreads,
                   all_reduce_mean, barrier, broadcast_module,
                   broadcast_object, data_parallel_step, free_port,
                   get_devices, is_lead, maybe_initialize_distributed,
                   process_group, rank, run_ranks, shard_batch,
                   shard_threads, world_size)

__all__ = ['HostLayout', 'ShardThreads',
           'all_reduce_mean', 'barrier', 'broadcast_module',
           'broadcast_object', 'data_parallel_step', 'free_port',
           'get_devices', 'is_lead', 'maybe_initialize_distributed',
           'process_group', 'rank', 'run_ranks', 'shard_batch',
           'shard_threads', 'world_size']

from .mesh import (all_gather, all_gather_object, all_reduce_grads, barrier, broadcast_,
                   close_distributed, global_count, global_mean, global_sum,
                   init_distributed, is_distributed, process_count,
                   process_index)

__all__ = [
    'init_distributed', 'close_distributed', 'is_distributed',
    'process_index', 'process_count', 'barrier', 'global_sum',
    'global_count', 'global_mean', 'all_reduce_grads', 'broadcast_',
    'all_gather', 'all_gather_object'
]

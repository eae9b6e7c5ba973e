from itermvs_tpu_torch.parallel.mesh import (
    all_reduce_grads_, all_reduce_sum, barrier, broadcast_state_, initialize_distributed,
    is_initialized, local_device, rank, world_size)

__all__ = ["all_reduce_grads_", "all_reduce_sum", "barrier", "broadcast_state_",
           "initialize_distributed", "is_initialized", "local_device", "rank",
           "world_size"]

"""Data parallelism and W-axis spatial sharding of the port over
``torch.distributed`` ranks."""
from .mesh import (TIME_MAJOR_KEYS, DataMesh, all_reduce_sum,
                   all_reduce_tree, barrier, broadcast_tree, global_mean,
                   global_sum, init_distributed, make_data_mesh, mean_share,
                   shard_batch, shard_batch_multihost, world_size)
from .spatial import (SpatialForward, SpatialMesh, active_plan, column_bounds,
                      gather_width, make_2d_mesh, make_spatial_forward,
                      shard_images)

__all__ = ["DataMesh", "TIME_MAJOR_KEYS", "all_reduce_sum", "all_reduce_tree",
           "barrier", "broadcast_tree", "global_mean", "global_sum",
           "init_distributed", "make_data_mesh", "mean_share", "shard_batch",
           "shard_batch_multihost", "world_size", "SpatialForward",
           "SpatialMesh", "active_plan", "column_bounds", "gather_width",
           "make_2d_mesh", "make_spatial_forward", "shard_images"]

"""Tensor ops of the port (JAX layouts at every public function)."""
from .cost import (block_cost, cat_fms, dif_fms, groupwise_correlation,
                   shift_right_features)
from .interpolate import avg_pool3d, resize_bilinear, resize_trilinear
from .sampling import (fractional_disparity_samples, linear_disparity_samples,
                       sort_samples_with_volume, topk_soft_argmin)
from .softsplat import softsplat
from .upsample import convex_upsample, mask_upsample_9, unfold3x3
from .warp import (grid_sample, inverse_warp, mesh_grid, project_to_3d,
                   shift_1d)

__all__ = [
    "avg_pool3d", "block_cost", "cat_fms", "convex_upsample", "dif_fms",
    "fractional_disparity_samples", "grid_sample", "groupwise_correlation",
    "inverse_warp", "linear_disparity_samples", "mask_upsample_9", "mesh_grid",
    "project_to_3d", "resize_bilinear", "resize_trilinear", "shift_1d",
    "shift_right_features", "softsplat", "sort_samples_with_volume",
    "topk_soft_argmin", "unfold3x3",
]

"""Tensor ops of the port (JAX layouts at every public function)."""
from .cost import (block_cost, cat_fms, dif_fms, groupwise_correlation,
                   shift_right_features)
from .interpolate import (adaptive_avg_pool2d, adaptive_max_pool2d,
                          avg_pool2d, avg_pool3d, max_pool2d, max_pool3d,
                          resize_bilinear, resize_trilinear, upsample_disp)
from .sampling import (fractional_disparity_samples, hard_argmin,
                       linear_disparity_samples, soft_argmin,
                       sort_samples_with_volume, topk_soft_argmin)
from .softsplat import softsplat, summation_splat
from .upsample import convex_upsample, mask_upsample_9, unfold3x3
from .warp import (grid_sample, inverse_warp, inverse_warp_3d, mesh_grid,
                   project_to_3d, shift_1d)

__all__ = [
    "adaptive_avg_pool2d", "adaptive_max_pool2d", "avg_pool2d", "avg_pool3d",
    "block_cost", "cat_fms", "convex_upsample", "dif_fms",
    "fractional_disparity_samples", "grid_sample", "groupwise_correlation",
    "hard_argmin", "inverse_warp", "inverse_warp_3d",
    "linear_disparity_samples", "mask_upsample_9", "max_pool2d", "max_pool3d",
    "mesh_grid", "project_to_3d", "resize_bilinear", "resize_trilinear",
    "shift_1d", "shift_right_features", "soft_argmin", "softsplat",
    "sort_samples_with_volume", "summation_splat", "topk_soft_argmin",
    "unfold3x3", "upsample_disp",
]

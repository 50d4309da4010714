"""Layers and blocks of the port (channels-first)."""
from .blocks import (SPP3D, BasicBlock, ConvexUpsample, DepthwiseConv3D,
                     DepthwiseConvTranspose3D, PredictionHeads, PyramidFusion,
                     ResidualBlock2D, ResidualBlock3D, StereoDRNetRefinement,
                     UNet)
from .layers import (BatchNorm, Conv2d, Conv3d, ConvGRU, ConvTranspose2d,
                     ConvTranspose3d, FrozenBatchNorm, GroupNorm,
                     InstanceNorm, LayerNorm, get_activation,
                     get_norm)

__all__ = ["BasicBlock", "BatchNorm", "Conv2d", "Conv3d", "ConvGRU",
           "ConvTranspose2d", "ConvTranspose3d", "ConvexUpsample",
           "DepthwiseConv3D", "DepthwiseConvTranspose3D", "FrozenBatchNorm",
           "GroupNorm", "InstanceNorm", "LayerNorm", "PredictionHeads",
           "PyramidFusion", "ResidualBlock2D", "ResidualBlock3D", "SPP3D",
           "StereoDRNetRefinement", "UNet", "get_activation", "get_norm"]

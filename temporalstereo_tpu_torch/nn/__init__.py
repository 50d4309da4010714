"""Layers and blocks of the port (channels-first)."""
from .blocks import (ConvexUpsample, DepthwiseConv3D, DepthwiseConvTranspose3D,
                     PredictionHeads, PyramidFusion, ResidualBlock3D, UNet)
from .layers import (Conv2d, Conv3d, ConvTranspose2d, ConvTranspose3d,
                     get_activation)

__all__ = ["Conv2d", "Conv3d", "ConvTranspose2d", "ConvTranspose3d",
           "ConvexUpsample", "DepthwiseConv3D", "DepthwiseConvTranspose3D",
           "PredictionHeads", "PyramidFusion", "ResidualBlock3D", "UNet",
           "get_activation"]

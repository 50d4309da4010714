"""TemporalStereo network of the port."""
from .aggregation import CostMemory
from .builder import build_model, resolve_device
from .prediction import Argmin, SoftArgmin, build_prediction
from .stereo import (PrevInfo, TemporalStereoNet, backbone_memory_shapes,
                     init_prev_info, update_prev_info)
from .temporal import chained_poses, multi_frame_forward, streaming_step

__all__ = ["Argmin", "CostMemory", "PrevInfo", "SoftArgmin",
           "TemporalStereoNet", "backbone_memory_shapes", "build_model",
           "build_prediction", "chained_poses",
           "init_prev_info", "multi_frame_forward", "resolve_device",
           "streaming_step",
           "update_prev_info"]

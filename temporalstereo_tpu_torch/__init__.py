"""temporalstereo_tpu_torch: the TemporalStereo port to PyTorch and CUDA.

It imports torch, numpy and the standard library only; the JAX package
``temporalstereo_tpu`` is the reference it is tested against.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
from .config import get_cfg
from .models import (build_model, backbone_memory_shapes, init_prev_info,
                     multi_frame_forward, streaming_step)
from .training import (TrainState, build_optimizer, make_train_step,
                       master_copies)

__all__ = ["TrainState", "backbone_memory_shapes", "build_model",
           "build_optimizer", "get_cfg", "init_prev_info", "make_train_step",
           "master_copies", "multi_frame_forward", "streaming_step"]

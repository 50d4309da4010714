"""Launch counters and the checks every kernel wrapper makes."""
from __future__ import annotations

LAUNCHES = {"fused_cost_base": 0, "fused_cost_base_backward": 0,
            "shift_1d": 0, "shift_1d_backward": 0, "summation_splat": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_no_grad(name: str, *tensors) -> None:
    """For a kernel without a backward: the model never differentiates the
    temporal splat (the JAX package stops the gradient right after it,
    ``models/stereo.py:239``, and on the carried state it reads), so a
    gradient reaching it is a fault in the caller."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: the model stops the "
                           "gradient at the temporal splat; detach its "
                           "inputs")


def cuda_device_index(name: str, *tensors) -> int:
    """Checks before a launch; returns the CUDA device index."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")
    return dev.index if dev.index is not None else 0

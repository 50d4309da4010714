"""Launch counters and the checks every kernel wrapper makes."""
from __future__ import annotations

LAUNCHES = {"fused_cost_base": 0, "summation_splat": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_no_grad(name: str, *tensors) -> None:
    """Neither kernel has a backward yet, so neither path takes gradients."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; call it under "
                           "torch.inference_mode() or no_grad()")


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

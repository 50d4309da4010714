"""Launch counters and the checks every kernel wrapper makes."""
from __future__ import annotations

# The backward kernels that scatter along W (csrc/row_owner.cuh): one warp
# per 32 channels of a gradient row, the slices of a row one cluster.
SLICE = 32
PAIRS = 8                     # pairs per step of the walk
RING_PAIRS = 4 * PAIRS        # pairs in the ring: 4 steps
MAX_SLICES = 8                # the portable cluster size
MAX_SHARED = 232448           # dynamic shared memory of one sm_90 block, bytes

LAUNCHES = {"fused_cost_base": 0, "fused_cost_base_backward": 0,
            "shift_1d": 0, "shift_1d_backward": 0, "softsplat": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def row_plan(channels: int, width: int, pairs: int, ring_elems: int,
             elem_size: int, stage_bytes: int):
    """(slices, shared bytes) of a row-owner backward kernel for a gradient
    row of ``width`` pixels and ``channels`` channels hit by ``pairs``
    (pixel, hypothesis) pairs: ceil(C / 32) slices of one warp each; per
    block the row's f32 accumulator [W + 1, 32] (the last row takes the
    invalid taps), one f32 per pair padded to whole steps of ``PAIRS``
    and one step more (its sampling position, then its partial sum over
    the slice), and, 16-byte aligned, a ring of ``RING_PAIRS`` pairs'
    inputs, ``ring_elems`` elements of ``elem_size`` bytes each, and two
    halves of the ``stage_bytes`` one step hands from the kernel's producer
    stage to its owner stage.  Raises ValueError for a shape that does not
    fit."""
    slices = -(-channels // SLICE)
    steps = -(-pairs // PAIRS) + 1
    shared = (-(-(4 * SLICE * (width + 1) + 4 * PAIRS * steps) // 16) * 16
              + RING_PAIRS * ring_elems * elem_size + 2 * stage_bytes)
    if slices > MAX_SLICES:
        raise ValueError(f"{channels} channels need {slices} slices of "
                         f"{SLICE}; a cluster holds at most {MAX_SLICES}")
    if shared > MAX_SHARED:
        raise ValueError(f"a row of {width} pixels with {pairs} pairs needs "
                         f"{shared} bytes of shared memory per block; the "
                         f"card gives at most {MAX_SHARED}")
    return slices, shared


SPLAT_NO_GRAD = "the model stops the gradient at the temporal splat"
SHARDED_NO_GRAD = "the W-sharded forward is inference only"


def check_no_grad(name: str, *tensors, reason: str = SPLAT_NO_GRAD) -> None:
    """For a kernel without a backward: the model never differentiates the
    temporal splat (the JAX package stops the gradient right after it,
    ``models/stereo.py:239``, and on the carried state it reads), nor the
    W-sharded forward (inference only), so a gradient reaching either is a
    fault in the caller."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: {reason}; detach its "
                           "inputs")


def cuda_device_index(name: str, *tensors, contiguous: bool = True) -> int:
    """Checks before a launch; returns the CUDA device index.  A kernel
    that reads its inputs with their own strides passes ``contiguous=False``
    and is only checked for the device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}, "
                             f"got {t.device}")
        if contiguous and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")
    return dev.index if dev.index is not None else 0

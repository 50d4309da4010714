"""Launch counters and the checks every kernel wrapper makes."""
from __future__ import annotations

import functools

# The backward kernels that scatter along W (csrc/row_owner.cuh): one warp
# per 32 channels of a gradient row, the slices of a row one cluster.
SLICE = 32
PAIRS = 8                     # pairs per step of the walk
RING_PAIRS = 4 * PAIRS        # pairs in the ring: 4 steps
MAX_SLICES = 8                # the portable cluster size
MAX_SHARED = 232448           # dynamic shared memory of one sm_90 block, bytes
# The shift forward (csrc/shift_1d.cu): one block of 256 threads per (img
# row, channel slice, block of hypotheses), the row's slice staged in
# shared memory.  The plan's preferences come from timing every plan on an
# H100 (scripts/port_shift_forward_sweep.py).
SMS = 132                     # streaming multiprocessors of an H100 SXM
SHIFT_THREADS = 256
SHIFT_BLOCK_BYTES = 48 * 1024  # several blocks resident on an SM
SHIFT_MIN_BLOCKS = 2 * SMS
SHIFT_BALANCE = 0.95          # grid / (SMS * ceil(grid / SMS)): how evenly
                              # the blocks spread over the SMs

LAUNCHES = {"fused_cost_base": 0, "fused_cost_base_backward": 0,
            "shift_1d": 0, "shift_1d_backward": 0, "softsplat": 0,
            "softsplat_backward": 0}


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


@functools.lru_cache(maxsize=256)
def shift_forward_plan(width_t: int, width: int, channels: int,
                       hypotheses: int, elem_size: int, rows: int):
    """(channel slices, hypotheses per block, shared bytes) of the shift
    forward kernel for ``rows`` img rows of ``width_t`` pixels, each read by
    ``hypotheses`` output rows of ``width`` pixels (D for an img broadcast
    over D, else 1).  A block stages its img row's slice of C / slices
    channels (padded to 16 bytes) and its hypotheses' f32 shift rows.
    Slices divide C into equal parts of whole 16-byte chunks (C % 8 == 0)
    or of channels, at most ``SHIFT_THREADS`` parts to a pixel.  Of the
    plans that fit ``MAX_SHARED`` it takes, in this order: a pixel's slice
    of all C or at least 64 bytes (narrower slices write 32-byte pieces); a
    block within ``SHIFT_BLOCK_BYTES``; a slice of all C or 256 bytes; a
    grid of up to ``SHIFT_MIN_BLOCKS`` blocks; a grid whose blocks spread
    over the SMs evenly to ``SHIFT_BALANCE``; the fewest blocks of
    hypotheses (each stages the row again); the fewest slices.  Raises
    ValueError for a shape that does not fit."""
    unit = 8 if channels % 8 == 0 else 1
    chunk = 16 // elem_size if unit == 8 else 1
    pers = sorted({-(-hypotheses // n) for n in range(1, hypotheses + 1)})
    best = None
    for slices in range(1, channels // unit + 1):
        part = channels // slices
        if channels // unit % slices or part // chunk > SHIFT_THREADS:
            continue
        row = -(-width_t * part * elem_size // 16) * 16
        pixel = part * elem_size
        for per in pers:
            shared = row + 4 * per * width
            if shared > MAX_SHARED:
                break
            blocks = -(-hypotheses // per)
            grid = rows * slices * blocks
            key = (part == channels or pixel >= 64,
                   shared <= SHIFT_BLOCK_BYTES,
                   part == channels or pixel >= 256,
                   min(grid, SHIFT_MIN_BLOCKS),
                   grid >= SHIFT_BALANCE * SMS * -(-grid // SMS), -blocks,
                   -slices)
            if best is None or key > best[0]:
                best = key, (slices, per, shared)
    if best is None:
        raise ValueError(f"an img row of {width_t} pixels and {channels} "
                         f"channels with a shift row of {width} needs more "
                         f"than {MAX_SHARED} bytes of shared memory per "
                         "block")
    return best[1]


def check_no_grad(name: str, *tensors) -> None:
    """For a kernel launch without a backward: the W-sharded forward (the
    column-offset launches) is inference only, so a gradient reaching it is
    a fault in the caller."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: the W-sharded forward "
                           "is inference only; detach its inputs")


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

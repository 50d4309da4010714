"""The yardstick's counts: bytes that the hand-written kernels must move at
a cell's shapes, the FLOPs of a frame, and the card's published peaks.

Bytes count each input read once and each output written once (the
formulas of the port's kernel table, ``PERF.md``); FLOPs are those of the
convolutions and matrix products of the benchmark's own reference forward
(``reference/``), counted by ``torch.utils.flop_counter`` on the meta
device, so that the count does not change with what implements the work.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
ELEM = {"bf16": 2, "f32": 4}


def cost_base_bytes(b: int, d: int, h: int, w: int, c: int,
                    elem: int) -> int:
    """One fused cost base (concat(ref, target warped to D hypotheses) and
    the groupwise correlation): ref and target [b, h, w, c] read,
    hypotheses [b, d, h, w] f32 read, the volume [b, d, h, w, 2c + c/8]
    written."""
    return b * (2 * h * w * c * elem + d * h * w * 4
                + d * h * w * (2 * c + c // 8) * elem)


def softsplat_bytes(b: int, h: int, w: int, c: int,
                    metric: bool = True) -> int:
    """One softmax splat of c f32 channels: inputs read and output written
    (2c), the flow (2 f32) and the metric (1 f32) read."""
    return b * h * w * (2 * c * 4 + 8 + (4 if metric else 0))


def steady_shapes(options: Dict[str, Any], h: int, w: int) -> Dict[str, Any]:
    """Per-frame shapes of a steady frame: the fine cost base at 1/8 (its
    fractional hypotheses and the local map's), the precise one at 1/4 (FPN
    and UNet features) and the splat at 1/8 (cost memory and local map)."""
    temporal = bool(options["MODEL.WITH_PREVIOUS"])
    lmap = int(options["MODEL.LOCAL_MAP_SIZE"]) if temporal else 0
    past = bool(options["MODEL.USE_PAST_COST"]) and temporal
    topk = int(options["MODEL.AGGREGATION.PRECISE.TOPK"])
    return {
        "fine": (int(options["MODEL.AGGREGATION.FINE.NUM_SAMPLE"])
                 + lmap, h // 8, w // 8,
                 int(options["MODEL.AGGREGATION.FINE.IN_PLANES"])),
        "precise": (int(options["MODEL.AGGREGATION.PRECISE.NUM_SAMPLE"]),
                    h // 4, w // 4,
                    2 * int(options["MODEL.AGGREGATION.PRECISE.IN_PLANES"])),
        "splat": ((h // 8, w // 8, 2 * topk * past + lmap)
                  if temporal and (past or lmap) else None),
    }


def tick_bytes(options: Dict[str, Any], b: int, h: int, w: int
               ) -> Dict[str, int]:
    """Bytes of a steady tick of b frames: ``cost_base`` (fine + precise)
    and ``softsplat`` (0 without a temporal update)."""
    s = steady_shapes(options, h, w)
    elem = ELEM[options["TRAINER.PRECISION"]]
    cost = sum(cost_base_bytes(b, *s[k], elem) for k in ("fine", "precise"))
    splat = softsplat_bytes(b, *s["splat"]) if s["splat"] else 0
    return {"cost_base": cost, "softsplat": splat}


def frame_flops(options: Dict[str, Any], h: int, w: int) -> float:
    """FLOPs of one steady frame of the reference network (batch 1), its
    convolutions and matrix products, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import net as ref

    meta = torch.device("meta")
    with meta:
        model = ref.Net(options).eval()
        state = ref.zero_state(model, 1, h, w, meta)
        if state is not None:
            lmap = model.local_map_size
            state = ref.State(
                state.memories, True, state.mem_sample, state.mem_cost,
                bool(options["MODEL.USE_PAST_COST"]), state.prev_disp,
                torch.zeros((1, h // 8, w // 8, lmap)), lmap > 0)
        left = torch.zeros((1, 3, h, w))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(left, left.clone(), state)
    return float(counter.get_total_flops())

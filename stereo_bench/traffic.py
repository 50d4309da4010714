"""The general generator of a traffic mix: frames, cameras, poses and the
ticks to check, all from ``--seed`` and the mix's parameters.

Frames follow the port's first bench (seeded noise, bf16, the KITTI
camera: focal 720 px, baseline 0.54 m), made distinct per seed, and are a
stereo pair: the right view is the left one's texture shifted by a
disparity, so that the cost volume has a match to find.  A pool of
``frame_pool`` pairs per stream is made on the card in a few calls and
kept in pinned host memory, from where each tick copies its frames in as a
camera's would arrive.  The pose between ticks moves ``forward_m`` forward,
``lateral_m`` right and turns ``yaw_deg``, then back again on the next
tick: with random weights a stream that only drives forward trusts its
warped state and its depth falls to zero within ten frames, so the
pattern alternates (each stream's phase from the seed) and the state stays
bounded over a window of hundreds of ticks.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import torch

FOCAL, BASELINE = 720.0, 0.54


def seeds(seed: int) -> Dict[str, int]:
    """Independent generator seeds of one run."""
    return {"weights": 2 * seed, "frames": 2 * seed + 1}


def frame_pool(traffic: Dict, b: int, h: int, w: int, seed: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left, right) [P, B, H, W, 3] bf16 in [0, 1), on the host (pinned
    when the device is a card): a smooth random texture (noise at half
    resolution, upsampled) seen by both views, the right one shifted by a
    disparity that grows row by row from ``disparity_px[0]`` at the top to
    ``[1]`` at the bottom, as a road's does."""
    p = int(traffic["frame_pool"])
    lo, hi = traffic["disparity_px"]
    g = torch.Generator(device=device).manual_seed(seeds(seed)["frames"])
    n, wt = p * b, w + int(hi) + 1
    tex = torch.rand((n, 3, h // 2 + 1, wt // 2 + 1), generator=g,
                     device=device)
    tex = torch.nn.functional.interpolate(tex, size=(h, wt),
                                          mode="bilinear")
    rows = torch.arange(h, device=device, dtype=torch.float32)
    disp = (lo + (hi - lo) * rows / max(h - 1, 1)).round().long()
    cols = torch.arange(w, device=device)[None, :] + disp[:, None]
    right = torch.gather(tex, 3, cols.expand(n, 3, h, w))
    both = torch.stack([tex[..., :w], right]).permute(0, 1, 3, 4, 2)
    both = both.reshape(2, p, b, h, w, 3).to(torch.bfloat16).cpu()
    if device.type == "cuda":
        both = both.pin_memory()
    return both[0], both[1]


def camera(b: int, h: int, w: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """K [B, 3, 3] (principal point at the centre) and baseline [B]."""
    K = torch.tensor([[FOCAL, 0.0, w / 2], [0.0, FOCAL, h / 2],
                      [0.0, 0.0, 1.0]], device=device)
    return (K.expand(b, 3, 3).contiguous(),
            torch.full((b,), BASELINE, device=device))


def _pose(forward: float, lateral: float, yaw_deg: float) -> torch.Tensor:
    c, s = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    return torch.tensor([[c, 0.0, s, lateral], [0.0, 1.0, 0.0, 0.0],
                         [-s, 0.0, c, -forward], [0.0, 0.0, 0.0, 1.0]])


def poses(traffic: Dict, b: int, seed: int, device) -> torch.Tensor:
    """T_past_to_now [2, B, 4, 4]: the poses of even and odd ticks, each
    stream starting the alternation at a phase drawn from the seed."""
    out = _pose(traffic["forward_m"], traffic["lateral_m"],
                traffic["yaw_deg"])
    back = torch.linalg.inv(out)
    rng = random.Random(seed)
    phase = [rng.randrange(2) for _ in range(b)]
    return torch.stack([
        torch.stack([(out, back)[(parity + phase[i]) % 2] for i in range(b)])
        for parity in (0, 1)]).to(device)


def check_times(traffic: Dict, seed: int) -> List[float]:
    """Fractions of the window, drawn from the seed, after which the next
    tick is one that the check compares."""
    rng = random.Random(seed ^ 0x5EED)
    return sorted(rng.uniform(0.05, 0.95)
                  for _ in range(int(traffic["check_ticks"])))

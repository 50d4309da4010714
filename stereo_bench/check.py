"""How ``correct`` is decided: the disparities the timed path returned, and
the state it carried on, held to the plain float32 reference
(``reference/``) with TF32 off.

The reference cannot run the stream freely beside the program: with random
weights a bf16 stream and a float32 one drift apart frame by frame, so it
follows the program step by step from the program's own state, as a
served language model's reference reads the served tokens.  For each
compared tick and stream it warps the program's state before the tick into
the tick's camera (the pose reprojection and the softmax splat), runs the
network on the tick's frames, and compares what the program returned and
carried on.  What following skips is checked by itself: the stream's
start, the first frame from the zero state.

The numbers, each the worst over the compared frames and streams:
  disp_p50_w          the median over pixels of |program - reference|
                      disparity, over the frame's width (a disparity
                      scales with it)
  disp_p50_rel        that median over the mean |reference| disparity (a
                      stream whose disparities are small reads alike)
  state_disp_p50_rel  the same of the disparity the tick carries on in its
                      state (what the next tick warps)
  feature_rel         the largest ||program - reference|| / ||reference||
                      over the backbone's features of both views at 1/4,
                      1/8 and 1/16 (what every cost stage reads)
  memory_rel          the same over the backbone's memory slices the tick
                      carries on
  cost_memory_p50_rel the median over elements of |program - reference|
                      over the mean |reference| of the cost memory's
                      hypotheses the tick carries on (the precise stage's
                      top two, as a set: sorted, since the stage after
                      sorts them and two near-equal costs swap on rounding;
                      their costs are not held, see PERF.md)
  warp_p99_px         the 99th percentile over the local map the tick
                      carried on (the previous disparities warped by the
                      temporal update, at 1/8) of |program - reference|:
                      the splat is discontinuous where a target's weight
                      reaches 0, so a few targets may flip on rounding
A configuration's file gives the limit of each number it compares (the
others are worked out for ``calibrate.py`` and not judged); the readings
they were set from are in ``PERF.md``.  The control
(``control=True``) is the reference in the program's place at the
precision below the configuration's: every convolution's operands rounded
to float8 e4m3 (the network is bf16), the temporal update's inputs to bf16
(it runs in float32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from .reference import layers as ref_layers
from .reference import net as ref_net


@dataclasses.dataclass
class Case:
    """One compared frame of one stream."""
    frames: tuple                # (left, right) [1, H, W, 3] of this stream
    camera: tuple                # (K, baseline, T) of the whole batch
    output: torch.Tensor         # the program's disparities, all streams
    row: int
    before: Optional[ref_net.State] = None    # the program's, all streams
    after: Optional[ref_net.State] = None     # the program's, this stream
    features: Optional[List[torch.Tensor]] = None   # the program's, NHWC,
                                                    # this stream


# A fault planted for calibrate.py: (case, the program's disparities and
# state after) -> what a broken program would have returned instead.
Fault = Callable[[Case, torch.Tensor, Optional[ref_net.State]],
                 Tuple[torch.Tensor, Optional[ref_net.State]]]


def reference_net(options: Dict, weights: Dict[str, torch.Tensor],
                  device: torch.device, rounding: Optional[str] = None
                  ) -> ref_net.Net:
    net = ref_net.Net(options).to(device)
    net.load_state_dict({k: v.to(device) for k, v in weights.items()})
    ref_layers.set_rounding(net, rounding)
    return net.eval()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    if not torch.isfinite(got).all():
        return math.inf
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _median_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The median over elements of |got - want| over the mean of |want|:
    a top-k selection flips on rounding alone at a few elements, which a
    norm would weigh in full."""
    return _quantile(got, want, 0.5) / float(
        want.abs().mean().clamp_min(1e-30))


def _quantile(got: torch.Tensor, want: torch.Tensor, q: float) -> float:
    """The q-quantile over elements of |got - want| (inf if got is not
    finite)."""
    if not torch.isfinite(got).all():
        return math.inf
    err = (got.float() - want).abs().flatten()
    return float(err.kthvalue(max(1, round(q * err.numel()))).values)


def numbers(disp: torch.Tensor, after: Optional[ref_net.State],
            features: Optional[List[torch.Tensor]], want_disp: torch.Tensor,
            want: Optional[ref_net.State], want_features: List[torch.Tensor]
            ) -> Dict[str, float]:
    """One frame's numbers: (disparities, state carried on, backbone
    features NHWC) against the reference's (features NCHW)."""
    width = disp.shape[-2]
    out = {"disp_p50_w": _quantile(disp, want_disp, 0.5) / width,
           "disp_p50_rel": _median_rel(disp, want_disp)}
    if features is not None:
        out["feature_rel"] = max(_rel(g, w.permute(0, 2, 3, 1)) for g, w in
                                 zip(features, want_features))
    if after is not None and want is not None:
        out["state_disp_p50_rel"] = _median_rel(after.prev_disp,
                                                want.prev_disp)
        out["memory_rel"] = max(_rel(g, w) for g, w in
                                zip(after.memories, want.memories))
        if want.mem_valid:
            out["cost_memory_p50_rel"] = _median_rel(
                after.mem_sample.sort(dim=-1).values,
                want.mem_sample.sort(dim=-1).values)
        if want.local_map.numel():
            out["warp_p99_px"] = _quantile(after.local_map, want.local_map,
                                           0.99)
    return out


def cases(checks, start_out, inputs, device) -> Iterator[Case]:
    """The compared frames: the start of each stream (from the zero
    state), then each compared tick of each stream, from the program's
    state before it."""
    left, right = inputs["left"], inputs["right"]
    K, baseline, T = inputs["K"], inputs["baseline"], inputs["T"]

    def frames(tick, row):
        p, one = tick % left.shape[0], slice(row, row + 1)
        return (left[p, one].to(device).float(),
                right[p, one].to(device).float())

    for row in range(start_out.shape[0]):
        yield Case(frames(0, row), (K, baseline, T[0]), start_out, row)
    for c in checks:
        before = c.before.reference() if c.before is not None else None
        after = c.after.reference() if c.after is not None else None
        for row in range(start_out.shape[0]):
            one = slice(row, row + 1)
            yield Case(frames(c.tick, row), (K, baseline, T[c.tick % 2]),
                       c.output, row, before,
                       ref_net.rows(after, one) if after else None,
                       [f[one].to(device) for f in c.features.tensors])


class BackboneTap:
    """The features the reference's backbone returned last ([l4, l8, l16,
    r4, r8, r16], NCHW)."""

    def __init__(self, net: ref_net.Net):
        self.features: List[torch.Tensor] = []
        net.backbone.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        self.features = [*output[0], *output[1]]


def run_step(net: ref_net.Net, case: Case, warped: dict,
             warp_rounding: Optional[str] = None):
    """The reference's frame of a case: from the zero state at the start,
    else from the program's state before the tick, warped into the tick's
    camera for the whole batch at once, as the program warps it (the
    splat's weights take a mean over the batch).  ``warped`` keeps the
    batch's warp for its other streams."""
    one = slice(case.row, case.row + 1)
    K, baseline, T = case.camera
    if case.before is None:
        left = case.frames[0]
        state = ref_net.zero_state(net, 1, left.shape[1], left.shape[2],
                                   left.device)
        return ref_net.step(net, *case.frames, state, K[one], baseline[one],
                            T[one], warp_rounding)
    if warped.get("before") is not case.before:
        warped.clear()
        warped["before"] = case.before
    if warp_rounding not in warped:
        warped[warp_rounding] = ref_net.update_state(
            case.before, K, baseline, T, tuple(case.frames[0].shape[1:3]),
            net.use_past_cost, net.local_map_size, warp_rounding)
    return ref_net.run(net, *case.frames,
                       ref_net.rows(warped[warp_rounding], one))


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


class no_tf32:
    """TF32 off for the reference, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def readings(checks, start_out, inputs, options, device,
             control: bool = False,
             faults: Optional[Dict[str, Fault]] = None
             ) -> Dict[str, Dict[str, float]]:
    """The numbers of a run: ``program`` against the reference; with
    ``control`` also the control in the program's place; and for each of
    ``faults`` the program's outputs as that fault would have changed
    them.  One reference frame a case serves them all."""
    with no_tf32(), torch.no_grad():
        net = reference_net(options, inputs["weights"], device)
        tap = BackboneTap(net)
        ctl = ctl_tap = None
        if control:
            ctl = reference_net(options, inputs["weights"], device, "fp8")
            ctl_tap = BackboneTap(ctl)
        rows: Dict[str, List[Dict[str, float]]] = {"program": []}
        warped: dict = {}
        for case in cases(checks, start_out, inputs, device):
            want_disp, want = run_step(net, case, warped)
            want_features = tap.features
            got = case.output[case.row:case.row + 1].to(device)
            rows["program"].append(numbers(got, case.after, case.features,
                                           want_disp, want, want_features))
            for name, fault in (faults or {}).items():
                disp, after = fault(case, got, case.after)
                rows.setdefault(name, []).append(numbers(
                    disp, after, case.features, want_disp, want,
                    want_features))
            if ctl is not None:
                disp, after = run_step(ctl, case, warped, "bf16")
                rows.setdefault("control", []).append(numbers(
                    disp, after if case.after is not None else None,
                    [f.permute(0, 2, 3, 1) for f in ctl_tap.features]
                    if case.features is not None else None,
                    want_disp, want, want_features))
        return {name: worst(r) for name, r in rows.items() if r}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number that has a limit within it, [(name, number, limit)])
    where a number the run did not give reads as infinite."""
    rows = [(k, numbers.get(k, math.inf), lim) for k, lim in limits.items()]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows

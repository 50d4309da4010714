"""One run of a cell: the port's served stream
(``temporalstereo_tpu_torch.serving.StreamingBundle.step``, one CUDA-graph
replay a tick for every stream of the bundle) driven by a traffic mix.

Set-up makes the weights and frames from the seed, builds the model and
its bundle (which captures every stage), runs the growth stages and a few
steady ticks, and counts all of it in ``setup_s``.  The window then runs
for ``seconds``: an open loop submits each tick at its due time and waits
for its disparity in host memory; a closed loop keeps ``in_flight`` ticks
submitted.  Ticks the check compares are drawn from the seed; around each,
the carried state and the backbone's features are copied aside (into
buffers made in set-up).  With
``trace`` a profiler covers the window's last ``profile_ticks`` ticks.  After the window the peak memory is read, the program
is freed, and ``check.py`` holds the kept outputs to the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import counts, traffic as gen
from .reference import layers as ref_layers
from .reference import net as ref_net
from .spec import Cell
from .trace import Trace, from_profiler

SLEEP_SLACK_S = 0.002      # an open loop sleeps to this short of a due time
                           # and spins the rest


@dataclasses.dataclass
class Tick:
    index: int
    due: float                 # host clock, s
    submit: float = math.nan   # the host span around ``step``
    stepped: float = math.nan
    done: float = math.nan     # its disparities seen in host memory
    profiled: bool = False     # submitted while the profiler ran


@dataclasses.dataclass
class Run:
    """What one run measured, as the metric readers read it."""
    cell: Cell
    batch: int
    height: int
    width: int
    seconds: float
    setup_s: float
    ticks: List[Tick]
    frames_done: int
    failed: int
    memory_peak_bytes: int
    bytes_per_tick: Dict[str, int]
    flops_per_frame: Optional[float] = None
    trace: Optional[Trace] = None


@dataclasses.dataclass
class Snapshot:
    """A copy of some of the program's tensors (its carried state, a
    ``PrevInfo``, or its backbone's features) in buffers of the harness."""
    tensors: List[torch.Tensor]
    flags: tuple = ()

    @staticmethod
    def like(tensors: List[torch.Tensor]) -> "Snapshot":
        return Snapshot([torch.empty_like(t) for t in tensors])

    def take(self, tensors: List[torch.Tensor], flags: tuple = ()) -> None:
        for dst, src in zip(self.tensors, tensors):
            dst.copy_(src, non_blocking=True)
        self.flags = flags

    def reference(self) -> ref_net.State:
        """The state held, as the reference's, in float32."""
        t = [x.float() for x in self.tensors]
        has_memory, mem_valid, lmap_valid = self.flags
        return ref_net.State(tuple(t[:-4]), has_memory, t[-4], t[-3],
                             mem_valid, t[-2], t[-1], lmap_valid)


def _tensors(state) -> List[torch.Tensor]:
    return [*state.memories, state.cost_memory.disp_sample,
            state.cost_memory.cost_volume, state.prev_disp, state.local_map]


def _flags(state) -> tuple:
    return (state.has_memory, state.cost_memory.valid, state.local_map_valid)


class Tap:
    """The newest state and backbone features ([l4, l8, l16, r4, r8, r16],
    NHWC) the model's forward returned.  On a card those are the last
    captured graph's outputs (the steady or the single stage's), which
    every replay of it rewrites; on the CPU (eager stages) each step's."""

    def __init__(self, model: torch.nn.Module):
        self.state = None
        self.features: List[torch.Tensor] = []
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        outputs, state = output
        self.features = [*outputs["left_feats"], *outputs["right_feats"]]
        if state is not None:
            self.state = state


@dataclasses.dataclass
class Check:
    """A tick the check compares: its frame and pose, the program's
    disparities, its backbone features, and its state before and after."""
    tick: int
    output: torch.Tensor
    features: Snapshot
    before: Optional[Snapshot] = None
    after: Optional[Snapshot] = None


def make_weights(options: Dict, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """The state_dict both sides load, from the seed in a few calls on the
    device: convolution weights N(0, 2 / fan_out) and biases N(0, 0.01^2),
    rounded to the served type; BatchNorm affine and statistics near
    identity (weight 1 + 0.1 N, bias 0.1 N, mean 0.1 N, variance
    1 + 0.2 U)."""
    with torch.device("meta"):
        shape_model = ref_net.Net(options)
    convs, norms = [], []
    for name, m in shape_model.named_modules():
        if isinstance(m, ref_layers._Conv):
            out_ch = (m.weight.shape[1] if isinstance(
                m, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d))
                else m.weight.shape[0])
            fan_out = out_ch * math.prod(m.weight.shape[2:])
            convs.append((f"{name}.weight", m.weight.shape,
                          math.sqrt(2.0 / fan_out)))
            if m.bias is not None:
                convs.append((f"{name}.bias", m.bias.shape, 0.01))
        elif isinstance(m, ref_layers.BatchNorm):
            norms.append((name, m.num_features))
    g = torch.Generator(device=device).manual_seed(gen.seeds(seed)["weights"])
    served = (torch.bfloat16 if options["TRAINER.PRECISION"] == "bf16"
              else torch.float32)
    out: Dict[str, torch.Tensor] = {}
    flat = torch.randn(sum(math.prod(s) for _, s, _ in convs), generator=g,
                       device=device)
    at = 0
    for key, shape, std in convs:
        n = math.prod(shape)
        out[key] = (flat[at:at + n].view(shape) * std).to(served).float()
        at += n
    n = sum(c for _, c in norms)
    normal = torch.randn((3, n), generator=g, device=device)
    uniform = torch.rand(n, generator=g, device=device)
    at = 0
    for name, c in norms:
        sl = slice(at, at + c)
        out[f"{name}.weight"] = 1 + 0.1 * normal[0, sl]
        out[f"{name}.bias"] = 0.1 * normal[1, sl]
        out[f"{name}.running_mean"] = 0.1 * normal[2, sl]
        out[f"{name}.running_var"] = 1 + 0.2 * uniform[sl]
        out[f"{name}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long, device=device)
        at += c
    for key, value in shape_model.state_dict().items():
        if key not in out:                  # the unused fine-stage phi
            out[key] = torch.zeros(value.shape, dtype=value.dtype,
                                   device=device)
    return out


def build_program(config: Dict, weights: Dict[str, torch.Tensor],
                  device: torch.device):
    """The port's model as the configuration runs it, with ``weights``."""
    from temporalstereo_tpu_torch import build_model, get_cfg

    opts: List[str] = []
    for key, value in config["options"].items():
        opts += [key, str(value)]
    model = build_model(get_cfg(opts=opts), device=device)
    model.load_state_dict(weights)
    return model


class Stepper:
    """One tick through the timed path: the frames copied in from pinned
    host memory, ``StreamingBundle.step``, the disparities copied out."""

    def __init__(self, bundle, left, right, K, baseline, T, device):
        self.bundle, self.left, self.right = bundle, left, right
        self.K, self.baseline, self.T = K, baseline, T
        self.device = device
        self.cuda = device.type == "cuda"

    def submit(self, i: int, out: torch.Tensor):
        p = i % self.left.shape[0]
        left = self.left[p].to(self.device, non_blocking=True)
        right = self.right[p].to(self.device, non_blocking=True)
        disp = self.bundle.step(left, right, self.K, self.baseline,
                                self.T[i % 2])
        out.copy_(disp, non_blocking=True)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            return ev
        return None

    @staticmethod
    def wait(ev) -> None:
        if ev is not None:
            ev.synchronize()


def _span(tracing: bool, name: str):
    return (torch.profiler.record_function(name) if tracing
            else contextlib.nullcontext())


def _window(stepper: Stepper, tap: Tap, mix: Dict, seed: int,
            seconds: float, trace: bool, i: int, ring, spare, checks
            ) -> Tuple[List[Tick], Optional[Trace]]:
    """The measured window from tick i: ticks submitted on the mix's
    schedule, the state copied aside around the ticks the check compares
    (``spare`` -> ``checks``), the last ``profile_ticks`` profiled."""
    open_loop = mix["loop"] == "open"
    in_flight = int(mix.get("in_flight", 1))
    n_open = int(seconds * float(mix.get("tick_hz", 0.0)))
    profile_ticks = int(mix["profile_ticks"])
    t0 = time.perf_counter()
    t_end = t0 + seconds
    check_at = [t0 + f * seconds for f in gen.check_times(mix, seed)]
    prof = None
    ticks: List[Tick] = []
    pending: List[tuple] = []           # (Tick, event)

    def finish(tick, ev) -> None:
        with _span(prof is not None, "bench.wait"):
            stepper.wait(ev)
        tick.done = time.perf_counter()

    while True:
        j = len(ticks)
        if open_loop:
            if j >= n_open:
                break
            due = t0 + j / float(mix["tick_hz"])
            now = time.perf_counter()
            if due > now:
                with _span(prof is not None, "bench.sleep"):
                    if due - now > SLEEP_SLACK_S:
                        time.sleep(due - now - SLEEP_SLACK_S)
                    while time.perf_counter() < due:
                        pass
            last = n_open - j <= profile_ticks
        else:
            due = time.perf_counter()
            if due >= t_end:
                break
            # the last profile_ticks ticks, at the rate so far
            last = j > 0 and t_end - due <= profile_ticks * (due - t0) / j
        if trace and prof is None and last:
            # the profiler runs to the window's end, so that its results
            # are gathered after it
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            prof_first = j
        check = None
        if spare and check_at and due >= check_at[0]:
            while check_at and due >= check_at[0]:
                check_at.pop(0)
            check = spare.pop(0)
            check.tick = i
            checks.append(check)
            if check.before is not None:
                check.before.take(_tensors(tap.state), _flags(tap.state))
        tick = Tick(i, due, profiled=prof is not None)
        with _span(prof is not None, "bench.submit"):
            tick.submit = time.perf_counter()
            ev = stepper.submit(i, check.output if check else
                                ring[i % len(ring)])
            tick.stepped = time.perf_counter()
        if check is not None:                # before the next replay
            check.features.take(tap.features)
            if check.after is not None:
                check.after.take(_tensors(tap.state), _flags(tap.state))
        ticks.append(tick)
        pending.append((tick, ev))
        if len(pending) >= in_flight:
            finish(*pending.pop(0))
        i += 1
    while pending:
        finish(*pending.pop(0))
    trace_data = None
    if prof is not None:
        prof.stop()
        trace_data = from_profiler(prof, len(ticks) - prof_first)
    return ticks, trace_data


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, since_start: Callable[[], float],
             log: Callable[[str], None]):
    """Set-up, the window and the program's outputs kept for the check ->
    (Run, [Check], start outputs, inputs) where inputs are what the
    reference needs (weights, frames, camera, poses)."""
    cfg, mix = cell.config, cell.traffic
    b, h, w = int(mix["streams"]), int(cfg["height"]), int(cfg["width"])
    pin = device.type == "cuda"

    weights = make_weights(cfg["options"], seed, device)
    model = build_program(cfg, weights, device)
    tap = Tap(model)
    from temporalstereo_tpu_torch.serving import StreamingBundle, bundle_meta

    bundle = StreamingBundle(bundle_meta(model, b, h, w,
                                         input_dtype=torch.bfloat16), model,
                             progress=log)
    left, right = gen.frame_pool(mix, b, h, w, seed, device)
    K, baseline = gen.camera(b, h, w, device)
    T = gen.poses(mix, b, seed, device)
    stepper = Stepper(bundle, left, right, K, baseline, T, device)

    def host_buffer():
        return torch.empty((b, h, w, 1), pin_memory=pin)

    ring = [host_buffer() for _ in range(int(mix.get("in_flight", 1)) + 1)]
    # set-up ticks: the growth stages (the first is the start the check
    # compares), then a few steady ones
    start_out = host_buffer()
    i = 0
    for _ in range(len(bundle.meta["stages"]) - 1
                   + int(mix["warm_steady_ticks"])):
        stepper.wait(stepper.submit(i, start_out if i == 0 else ring[0]))
        i += 1
    start_out = start_out.clone()
    checks: List[Check] = []
    n_checks = int(mix["check_ticks"])
    spare = [Check(-1, host_buffer(), Snapshot.like(tap.features),
                   *((Snapshot.like(_tensors(tap.state)),
                      Snapshot.like(_tensors(tap.state)))
                     if tap.state is not None else ()))
             for _ in range(n_checks)]
    if trace:
        # the profiler's first session pays its start-up; keep it out of
        # the window
        with torch.profiler.profile():
            stepper.wait(stepper.submit(i, ring[0]))
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = since_start()

    ticks, trace_data = _window(stepper, tap, mix, seed, seconds, trace,
                                i, ring, spare, checks)
    done_in_window = sum(1 for t in ticks if t.done - ticks[0].due <= seconds)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    run = Run(cell=cell, batch=b, height=h, width=w, seconds=seconds,
              setup_s=setup_s, ticks=ticks,
              frames_done=b * done_in_window,
              failed=sum(1 for t in ticks if math.isnan(t.done)),
              memory_peak_bytes=memory_peak,
              bytes_per_tick=counts.tick_bytes(cfg["options"], b, h, w),
              trace=trace_data)
    inputs = {"weights": weights, "left": left, "right": right, "K": K,
              "baseline": baseline, "T": T}
    tap.handle.remove()
    del bundle, model, tap, stepper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, checks, start_out, inputs

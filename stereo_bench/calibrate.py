"""The readings that the check's limits are set from, on the card.

    python3 -m stereo_bench.calibrate --workload NAME --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 3] [--out FILE]

For each seed, in one process: the cell's set-up and a short window at its
own load through the same harness as a run (the same ticks compared), then
``check.readings``: the numbers of the program against the reference, of
the faults below worked out from the same kept outputs and states, and,
for the control seeds, of the control (``check.py``) in the program's
place.  One JSON line a seed on standard output and in ``--out``.
``PERF.md`` gives the readings each limit was set from.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from . import check, serve, spec
from .reference import net as ref_net
from .run import log, since_start


def _other(case: check.Case) -> slice:
    row = (case.row + 1) % case.output.shape[0]
    return slice(row, row + 1)


def _answer_left_out(case, got, after):
    return torch.zeros_like(got), after


def _answers_swapped(case, got, after):
    return case.output[_other(case)].to(got.device), after


def _state_unchanged(case, got, after):
    if case.before is None:
        return got, after
    return got, ref_net.rows(case.before, slice(case.row, case.row + 1))


def _cost_memory_unchanged(case, got, after):
    if case.before is None or after is None:
        return got, after
    before = ref_net.rows(case.before, slice(case.row, case.row + 1))
    return got, dataclasses.replace(after, mem_sample=before.mem_sample,
                                    mem_cost=before.mem_cost)


def _state_disp_swapped(case, got, after):
    if after is None:
        return got, after
    return got, dataclasses.replace(
        after, prev_disp=case.output[_other(case)].to(got.device).float())


# the faults a served cell can have, each as the check would see it
FAULTS = {
    "answer_left_out": _answer_left_out,        # half a batch, or a frame
    "answers_swapped": _answers_swapped,        # of two streams
    "state_unchanged": _state_unchanged,        # a step returns its state
    "cost_memory_unchanged": _cost_memory_unchanged,
    "state_disp_swapped": _state_disp_swapped,  # another stream's carried
}


def faults_of(batch: int, temporal: bool) -> dict:
    """The faults a cell of this batch and state can have."""
    out = dict(FAULTS)
    if batch < 2:
        out.pop("answers_swapped")
        out.pop("state_disp_swapped")
    if not temporal:
        for name in ("state_unchanged", "cost_memory_unchanged",
                     "state_disp_swapped"):
            out.pop(name, None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    device = torch.device("cuda")
    cell = spec.resolve(args.workload)
    options = cell.config["options"]
    faults = faults_of(int(cell.traffic["streams"]),
                       bool(options["MODEL.WITH_PREVIOUS"]))
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            run, checks, start_out, inputs = serve.run_cell(
                cell, seed, args.seconds, False, device, since_start, log)
            row = {"workload": cell.name, "seed": seed,
                   "ticks": len(run.ticks),
                   "checked": [c.tick for c in checks],
                   "disp_abs_max": max(float(c.output.abs().max())
                                       for c in checks)}
            row.update(check.readings(checks, start_out, inputs, options,
                                      device, control=seed in controls,
                                      faults=faults))
            row["seconds"] = time.perf_counter() - t
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del run, checks, start_out, inputs
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

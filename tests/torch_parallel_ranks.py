"""One rank of tests/test_torch_parallel.py's two-rank gloo group.

    python -m tests.torch_parallel_ranks DIR RANK WORLD

Joins the group through the file store ``DIR/store`` (every collective
raises after 60 s), reads the job that the test wrote to ``DIR/job.pt``
and writes what this rank computed to ``DIR/rank<RANK>.pt``: the mesh's
refusals, the temporal update of a carried state, one training step and
one eval step of the tiny model on this rank's shard of the job's global
batches, and a ``Trainer`` fit and its resume with ``multihost=True``.
It imports torch and the port only.
"""
import datetime
import os
import sys

import torch
import torch.distributed as dist

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.models.aggregation import CostMemory
from temporalstereo_tpu_torch.models.stereo import (PrevInfo, _splat_metric,
                                                    update_prev_info)
from temporalstereo_tpu_torch.parallel import make_data_mesh, shard_batch
from temporalstereo_tpu_torch.training import (GradientTransformation,
                                               TrainState, build_optimizer,
                                               make_eval_step,
                                               make_train_step, master_copies)
from temporalstereo_tpu_torch.training.optim import chain
from temporalstereo_tpu_torch.training.trainer import Trainer
from temporalstereo_tpu_torch.utils import logging as port_logging


def stash():
    """Passes the gradients on and keeps them as its state."""
    return GradientTransformation(
        lambda p: {k: torch.zeros_like(v) for k, v in p.items()},
        lambda g, s, p=None: (g, g))


def refusals(world):
    out = {}
    for name, kwargs in (("indivisible", {"global_batch": 2 * world + 1}),
                         ("mesh_data", {"global_batch": 2 * world,
                                        "max_ranks": world + 1})):
        try:
            make_data_mesh(**kwargs)
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def warp(job, mesh):
    """``update_prev_info`` of this rank's shard of a carried state, and
    the splat metric of its full-resolution disparity."""
    w = shard_batch(mesh, job["warp"])
    prev = PrevInfo(memories=(), has_memory=True,
                    cost_memory=CostMemory(w["disp_sample"], w["cost_volume"],
                                           True),
                    prev_disp=w["prev_disp"], local_map=w["local_map"],
                    local_map_valid=True)
    out = update_prev_info(prev, w["K"], w["baseline"], w["T"],
                           tuple(w["prev_disp"].shape[1:3]), True, 3, mesh)
    return {"disp_sample": out.cost_memory.disp_sample,
            "cost_volume": out.cost_memory.cost_volume,
            "local_map": out.local_map,
            "metric": _splat_metric(w["prev_disp"], mesh)}


def train_and_eval(job, mesh):
    cfg = get_cfg(job["config"], opts=job["opts"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(job["state_dict"], strict=True)
    params, stats = master_copies(model)
    state = TrainState.create(params, stats,
                              chain(stash(), build_optimizer(cfg, 10)))
    step = make_train_step(model, cfg, mesh=mesh)
    state, metrics = step(state, shard_batch(mesh, job["train_batch"]))
    evaluate = make_eval_step(model, cfg, mesh=mesh)
    return {"train": {"metrics": {k: float(v) for k, v in metrics.items()},
                      "grads": state.opt_state[0], "params": state.params,
                      "stats": state.batch_stats, "step": state.step},
            "eval": {k: float(v) for k, v in
                     evaluate(shard_batch(mesh, job["eval_batch"])).items()}}


def fit(job, rank):
    """The fit and its resume; the validation tables each leg computed and
    the names of the images each leg logged."""
    tables, images = [], []
    run_eval = Trainer._run_eval
    log_image = port_logging.MetricLogger.log_image

    def recording_eval(self, *args, **kwargs):
        means = run_eval(self, *args, **kwargs)
        tables.append(means)
        return means

    def recording_image(self, step, name, image):
        images.append(name)
        return log_image(self, step, name, image)
    Trainer._run_eval = recording_eval
    port_logging.MetricLogger.log_image = recording_image
    legs = []
    try:
        for opts in (job["fit_opts"][rank], job["resume_opts"][rank]):
            trainer = Trainer(get_cfg(opts=opts), device="cpu",
                              multihost=True)
            restored = {"step": trainer.state.step,
                        "params": dict(trainer.state.params)}
            trainer.fit()
            trainer.close()
            legs.append({"restored": restored, "step": trainer.state.step,
                         "swa_count": trainer.state.swa_count,
                         "params": trainer.state.params,
                         "stats": trainer.state.batch_stats,
                         "tables": list(tables), "images": list(images)})
            tables.clear()
            images.clear()
    finally:
        Trainer._run_eval = run_eval
        port_logging.MetricLogger.log_image = log_image
    return legs


def main(directory, rank, world):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(directory, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        job = torch.load(os.path.join(directory, "job.pt"),
                         weights_only=False)
        mesh = make_data_mesh(2 * world, max_ranks=world)
        out = {"backend": dist.get_backend(), "rank": mesh.rank,
               "world": mesh.world, "refusals": refusals(world),
               "warp": warp(job, mesh)}
        out.update(train_and_eval(job, mesh))
        out["fit"] = fit(job, rank)
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

"""The port's data parallelism (temporalstereo_tpu_torch.parallel) on two
gloo ranks on the CPU, against the JAX package's sharded step and the
port's own single-process run.

Two processes (``tests/torch_parallel_ranks.py``) join a gloo group
through a file store under the test's temporary directory, while this
process computes the references; the group has a deadline (``DEADLINE``
seconds, after which both ranks are killed and the test fails) and each of
its collectives a 60 s timeout.  On the same global batches and weights
(the tiny f32 temporal model and batches of tests/test_torch_train_step.py,
a T=3 window at global B=2, one sample a rank) the ranks run:
  * the temporal update (``update_prev_info``) of a carried state: each
    rank's warped state equals its slice of the one-process update within
    1e-5 relative, and its splat metric takes the disparity's mean over
    the global batch, as JAX's sharded step does: on the full-resolution
    disparities, 10-30 px and 880-900 px for the two samples, the metric
    clamps at +-50 with the global mean and not with each rank's own;
  * one training step, held against JAX's ``make_sharded_train_step`` over
    ``make_mesh(jax.devices()[:2])`` with ``check_train_step``'s
    tolerances (tests/test_torch_train_step.py, whose docstring says why),
    and against the port's single-process step at B=2: every loss term
    within ``DP_TOL`` (1e-5) relative, each BatchNorm statistic and
    parameter after the step within 1e-5 of its tensor's largest value;
    ``grad_norm`` within ``DP_GRAD_TOL`` (1e-4) relative and each gradient
    within 1e-4 of the model's largest gradient.  The synchronised
    BatchNorm sums in another order than ``F.batch_norm``, and a train-mode
    backward through this depth amplifies rounding: the two sides' losses
    were 1.4e-6 apart and their gradients 2.9e-5 of the largest
    (``grad_norm`` 2.2e-5), where the single process against itself with
    its two samples swapped moved them by 1.4e-5 (7.7e-6).  The two ranks'
    states are bit-equal;
  * one eval step of 3 samples over the 2 ranks, so that one rank holds a
    wrap-padded duplicate (``pad_mask`` 0): its metrics and ``weight``
    equal the single-process step over the 3 real samples within 1e-6
    relative (sums in another order);
  * a ``Trainer`` fit (``multihost=True``; the split and options of
    tests/test_torch_trainer.py, B=1 a rank against B=2 in one process,
    with image logs every step) and a resume from rank 0's checkpoints:
    only rank 0 writes under its ``LOG_DIR`` and logs images, the ranks'
    validation tables are equal, each resume restores rank 0's saved
    step and state, and the tables, parameters and statistics equal the
    single-process fit's within ``FIT_TOL``.  Both sides run one thread
    (``FIT_THREADS``): a train-mode BatchNorm on the CPU reduces a
    channels-last input (the images' NHWC layout, permuted) in blocks of
    the thread count, and the fit amplifies that rounding.  The single
    process against itself at 1, 2 and 8 threads moved the tables by up
    to 1.3e-2 relative, the parameters by 4.0e-5 and the statistics by
    4.8e-2 of their max; the ranks against it at one thread, 3.2e-4,
    1.1e-5 and 3.5e-3.  ``FIT_TOL`` is that one-thread gap with a margin
    of about 3; it fails a fit whose BatchNorms take each rank's own
    statistics, or whose gradients are not summed over the ranks.
The mesh's layout is held to JAX's ``TIME_MAJOR_KEYS`` sharding, and its
refusals and ``init_distributed``'s choice of backend are checked.
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import NamedSharding, PartitionSpec

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.parallel import mesh as jax_mesh
from temporalstereo_tpu.training import TrainState as JaxTrainState
from temporalstereo_tpu.training import build_optimizer as jax_optimizer
from temporalstereo_tpu.training import make_train_step as jax_train_step

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.models.aggregation import CostMemory
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.models.stereo import (PrevInfo, _splat_metric,
                                                    update_prev_info)
from temporalstereo_tpu_torch.parallel import (TIME_MAJOR_KEYS, DataMesh,
                                               init_distributed,
                                               make_data_mesh, shard_batch)
from temporalstereo_tpu_torch.training import (TrainState, build_optimizer,
                                               make_eval_step,
                                               make_train_step, master_copies)
from temporalstereo_tpu_torch.training.optim import chain
from temporalstereo_tpu_torch.training.trainer import Trainer
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

from tests.test_torch_train_step import (FAST_COMPILE, FLOOR, GRAD_TOL, H,
                                         KITTI, LOSS_TOL, PARAM_TOL,
                                         STATS_TOL, TINY, W, _as_port,
                                         _jax_stash, _jax_variables,
                                         _max_abs, _port_stash)
from tests.test_torch_trainer import _opts, init_ckpt, split  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
DEADLINE = 300
DP_TOL, DP_GRAD_TOL, EVAL_TOL = 1e-5, 1e-4, 1e-6
# the fit's bounds: the ranks' gap at one thread, with a margin of ~3
FIT_TOL = {"table": 1e-3, "param": 3e-5, "stat": 1e-2}
FIT_THREADS = 1                 # tests/torch_parallel_ranks.py's
OPTS = TINY + ["OPTIMIZER.RMSPROP.LR", "1e-6"]
VIS = ["VAL.VIS_BATCH_INDEX", "1", "TRAINER.VIS_EVERY_N_TRAIN_STEPS", "1"]


def _window(t, b, seed):
    """A window of t frames of b samples: images, a sparse positive
    disparity ground truth (0 = invalid), a slow sideways-forward camera
    motion, K and the baseline (tests/test_torch_train_step.py's, per
    sample)."""
    rng = np.random.RandomState(seed)
    T_cam = np.tile(np.eye(4, dtype=np.float32), (t, b, 1, 1))
    for i in range(t):
        T_cam[i, :, 0, 3], T_cam[i, :, 2, 3] = 0.03 * i, -0.05 * i
    gt = rng.uniform(1.0, 40.0, (t, b, H, W, 1)).astype(np.float32)
    gt[rng.rand(*gt.shape) < 0.7] = 0.0
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    return {"left": rng.rand(t, b, H, W, 3).astype(np.float32),
            "right": rng.rand(t, b, H, W, 3).astype(np.float32),
            "disp_gt": gt, "T_cam": T_cam, "inv_T": np.linalg.inv(T_cam),
            "K": np.tile(K, (b, 1, 1)),
            "baseline": np.full((b,), 2.0, np.float32)}


def _take(batch, idx):
    return {k: np.take(v, idx, axis=1 if k in TIME_MAJOR_KEYS else 0)
            for k, v in batch.items()}


def _carried_state(seed):
    """A carried state of 2 samples at 96x128 (1/8: 12x16, top-2 cost
    memory, a 3-channel local map, disparities near 10 and 150 px), its
    full-resolution disparities 10-30 and 880-900 px; 3 cm sideways and
    5 cm forward."""
    rng = np.random.RandomState(seed)
    h8, w8 = H // 8, W // 8
    base = np.array([10.0, 150.0], np.float32)[:, None, None, None]
    far = np.array([10.0, 880.0], np.float32)[:, None, None, None]
    T = np.tile(np.eye(4, dtype=np.float32), (WORLD, 1, 1))
    T[:, 0, 3], T[:, 2, 3] = 0.03, -0.05
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    return {"prev_disp": far + 20 * rng.rand(WORLD, H, W, 1).astype(
                np.float32),
            "disp_sample": base + 20 * rng.rand(WORLD, h8, w8, 2).astype(
                np.float32),
            "cost_volume": rng.randn(WORLD, h8, w8, 2).astype(np.float32),
            "local_map": base + 20 * rng.rand(WORLD, h8, w8, 3).astype(
                np.float32),
            "K": np.tile(K, (WORLD, 1, 1)),
            "baseline": np.full((WORLD,), 2.0, np.float32), "T": T}


def _single_warp(state):
    w = {k: torch.from_numpy(v) for k, v in state.items()}
    prev = PrevInfo(memories=(), has_memory=True,
                    cost_memory=CostMemory(w["disp_sample"], w["cost_volume"],
                                           True),
                    prev_disp=w["prev_disp"], local_map=w["local_map"],
                    local_map_valid=True)
    out = update_prev_info(prev, w["K"], w["baseline"], w["T"], (H, W),
                           True, 3)
    return {"disp_sample": out.cost_memory.disp_sample,
            "cost_volume": out.cost_memory.cost_volume,
            "local_map": out.local_map,
            "metric": _splat_metric(w["prev_disp"])}


def _exp_dir(opts):
    cfg = get_cfg(opts=opts)
    return os.path.join(cfg.LOG_DIR, cfg.TRAINER.NAME, cfg.TRAINER.VERSION)


def _launch(directory):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_ranks", str(directory),
         str(r), str(WORLD)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _join(procs, directory, t_end):
    """Each rank's result; both ranks killed at the deadline or when one
    fails."""
    logs = [None] * len(procs)
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=max(t_end - time.time(), 1))[0]
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{logs[r][-4000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the two ranks passed their {DEADLINE} s "
                             "deadline") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(directory / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_sharded_step(jmodel, jcfg, variables, batch):
    """JAX's sharded step over a 2-device mesh, XLA's CPU optimisations
    off (as tests/test_torch_train_step.py compiles it)."""
    mesh = jax_mesh.make_mesh(jax.devices()[:WORLD])
    jstate = JaxTrainState.create(
        variables["params"], variables["batch_stats"],
        optax.chain(_jax_stash(), jax_optimizer(jcfg, 10)))
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    step = jax_mesh.make_sharded_train_step(jax_train_step(jmodel, jcfg),
                                            mesh, donate=False)
    jit = jax.jit
    jax.jit = lambda fun, **kw: jit(fun, compiler_options=FAST_COMPILE, **kw)
    try:
        with jax.default_matmul_precision("highest"):
            return step(jstate, jax_mesh.shard_batch(mesh, batch))
    finally:
        jax.jit = jit


def _single_step(job):
    """The port's single-process step and eval step on the global batches
    (the eval over the 3 real samples)."""
    cfg = get_cfg(KITTI, opts=OPTS)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(job["state_dict"], strict=True)
    params, stats = master_copies(model)
    state = TrainState.create(params, stats,
                              chain(_port_stash(), build_optimizer(cfg, 10)))
    state, metrics = make_train_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in job["train_batch"].items()})
    real = _take(job["eval_batch"], [0, 2, 1])
    real.pop("pad_mask")
    evaluated = make_eval_step(model, cfg)(
        {k: torch.from_numpy(v) for k, v in real.items()})
    return ({"metrics": {k: float(v) for k, v in metrics.items()},
             "grads": state.opt_state[0], "params": state.params,
             "stats": state.batch_stats, "step": state.step},
            {k: float(v) for k, v in evaluated.items()})


def _single_fit(opts, resume_opts):
    threads = torch.get_num_threads()
    torch.set_num_threads(FIT_THREADS)
    try:
        return _fit_legs(opts, resume_opts)
    finally:
        torch.set_num_threads(threads)


def _fit_legs(opts, resume_opts):
    legs = []
    for o in (opts, resume_opts):
        tables = []
        trainer = Trainer(get_cfg(opts=o), device="cpu")
        run_eval = trainer._run_eval
        trainer._run_eval = lambda *a, **k: tables.append(
            run_eval(*a, **k)) or tables[-1]
        trainer.fit()
        trainer.close()
        legs.append({"step": trainer.state.step,
                     "params": trainer.state.params,
                     "stats": trainer.state.batch_stats, "tables": tables})
    return legs


@pytest.fixture(scope="module")
def runs(split, init_ckpt, tmp_path_factory):  # noqa: F811
    """(the ranks' results, JAX's sharded step, the single-process step,
    eval and fit, the fit's options)."""
    directory = tmp_path_factory.mktemp("ranks")
    jcfg = jax_get_cfg(KITTI, opts=OPTS)
    jmodel = jax_build_model(jcfg, dtype=None)
    variables = _jax_variables(jmodel, seed=41)
    fit_opts = [_opts(split, directory / f"fit{r}", batch=1) + VIS
                for r in range(WORLD)]
    ckpts = os.path.join(_exp_dir(fit_opts[0]), "checkpoints")
    warm = ["TRAINER.LOAD_FROM_CHECKPOINT", init_ckpt[0]]
    job = {"config": KITTI, "opts": OPTS,
           "state_dict": state_dict_from_jax(variables["params"],
                                             variables["batch_stats"],
                                             TINY_GROUPS),
           "warp": _carried_state(seed=46),
           "train_batch": _window(3, WORLD, seed=42),
           # 3 real samples over 2 ranks: rank 1's second is a duplicate
           "eval_batch": dict(_take(_window(3, 3, seed=45), [0, 2, 1, 1]),
                              pad_mask=np.array([1, 1, 1, 0], np.int64)),
           "fit_opts": [o + warm for o in fit_opts],
           "resume_opts": [o + ["TRAINER.RESUME_FROM_CHECKPOINT", ckpts]
                           for o in fit_opts]}
    torch.save(job, directory / "job.pt")
    t_end = time.time() + DEADLINE
    procs = _launch(directory)
    try:
        jout = _jax_sharded_step(jmodel, jcfg, variables, job["train_batch"])
        single, single_eval = _single_step(job)
        single_warp = _single_warp(job["warp"])
        single_dir = directory / "single"
        single_opts = _opts(split, single_dir, batch=WORLD) + VIS
        single_fit = _single_fit(single_opts + warm, single_opts + [
            "TRAINER.RESUME_FROM_CHECKPOINT",
            os.path.join(_exp_dir(single_opts), "checkpoints")])
    finally:
        ranks = _join(procs, directory, t_end)
    return {"ranks": ranks, "jax": jout, "init": job["state_dict"],
            "single": single,
            "single_eval": single_eval, "single_fit": single_fit,
            "single_warp": single_warp,
            "fit_dirs": [directory / f"fit{r}" for r in range(WORLD)],
            "ckpts": ckpts}


def _assert_close(ours, ref, tol, floor, what):
    for k, v in ref.items():
        err = _max_abs(ours[k].numpy() - v.numpy())
        assert err <= tol * _max_abs(v.numpy()) + floor, f"{what} {k}: {err}"


def test_ranks_join_one_gloo_group_and_refuse_a_bad_mesh(runs):
    for r, out in enumerate(runs["ranks"]):
        assert (out["backend"], out["rank"], out["world"]) == ("gloo", r, 2)
        assert "do not divide the global batch" in out["refusals"][
            "indivisible"]
        assert "TPU.MESH.DATA=3 but 2 rank(s)" in out["refusals"][
            "mesh_data"]


def test_two_rank_temporal_update_takes_the_global_mean(runs):
    metric = runs["single_warp"]["metric"]
    assert float(metric[0].max()) == -50.0 and float(metric[1].min()) == 50.0
    for r, out in enumerate(runs["ranks"]):
        for k, v in runs["single_warp"].items():
            ref = v[r:r + 1]
            err = float((out["warp"][k] - ref).abs().max())
            assert err <= 1e-5 * float(ref.abs().max()), f"rank {r} {k}: {err}"


def test_two_rank_step_matches_jax_sharded_step(runs):
    """check_train_step's tolerances, on the first step."""
    jstate, jm = runs["jax"]
    ours = runs["ranks"][0]["train"]
    assert set(ours["metrics"]) == set(jm)
    for k in jm:
        rel = abs(ours["metrics"][k] - float(jm[k])) / abs(float(jm[k]))
        assert rel < LOSS_TOL, f"{k}: {ours['metrics'][k]} vs {float(jm[k])}"
    jgrads = _as_port(jstate.opt_state[0], jstate.batch_stats,
                      ours["grads"], TINY_GROUPS)
    top = max(_max_abs(g) for g in jgrads.values())
    for k, g in ours["grads"].items():
        err = _max_abs(g.numpy() - jgrads[k])
        assert err <= GRAD_TOL * _max_abs(jgrads[k]) + FLOOR * top, \
            f"gradient {k}: {err:.3g}"
    jstats = _as_port(jstate.params, jstate.batch_stats, ours["stats"],
                      TINY_GROUPS)
    for k, s in ours["stats"].items():
        err = _max_abs(s.numpy() - jstats[k])
        assert err <= STATS_TOL * _max_abs(jstats[k]), f"statistic {k}"
    jparams = _as_port(jstate.params, jstate.batch_stats, ours["params"],
                       TINY_GROUPS)
    moved = {k: _max_abs(jparams[k] - runs["init"][k].numpy())
             for k in jparams}
    assert max(moved.values()) > 1e-7            # the step moved the weights
    for k, p in ours["params"].items():
        err = _max_abs(p.numpy() - jparams[k])
        assert err <= (PARAM_TOL * moved[k] + 2 ** -22 * _max_abs(jparams[k])
                       + FLOOR * max(moved.values())), \
            f"parameter {k}: {err:.3g}"


def test_two_rank_step_matches_single_process_step(runs):
    """The ranks bit-equal; both within DP_TOL of one process at B=2."""
    a, b = (r["train"] for r in runs["ranks"])
    assert a["metrics"] == b["metrics"] and a["step"] == b["step"] == 1
    for part in ("grads", "params", "stats"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), f"{part} {k}"
    single = runs["single"]
    for k, v in single["metrics"].items():
        tol = DP_GRAD_TOL if k == "grad_norm" else DP_TOL
        assert abs(a["metrics"][k] - v) <= tol * abs(v), \
            f"{k}: {a['metrics'][k]} vs {v}"
    top = max(_max_abs(g.numpy()) for g in single["grads"].values())
    _assert_close(a["grads"], single["grads"], 0.0, DP_GRAD_TOL * top,
                  "gradient")
    for part in ("params", "stats"):
        _assert_close(a[part], single[part], DP_TOL, 0.0, part)


def test_two_rank_eval_counts_padded_duplicates_nowhere(runs):
    a, b = (r["eval"] for r in runs["ranks"])
    assert a == b
    ref = runs["single_eval"]
    assert set(a) == set(ref) and a["weight"] == ref["weight"] == 3.0
    for k, v in ref.items():
        assert abs(a[k] - v) <= EVAL_TOL * abs(v), f"{k}: {a[k]} vs {v}"


def test_two_rank_fit_gates_writes_on_rank_zero_and_resumes(runs):
    rank0, rank1 = (r["fit"] for r in runs["ranks"])
    assert not runs["fit_dirs"][1].exists()
    exp0 = pathlib.Path(runs["ckpts"]).parent
    assert (exp0 / "log.txt").exists() and (exp0 / "weights_final.pth"
                                            ).exists()
    assert (exp0 / "tb" / "metrics.jsonl").exists()
    assert sorted(os.listdir(runs["ckpts"])) == sorted(
        [f"checkpoint-{s}.pt" for s in (2, 4)]
        + [f"hparams-{s}.json" for s in (2, 4)])
    for leg0, leg1 in zip(rank0, rank1):
        assert leg0["images"] and not leg1["images"]
        assert leg0["tables"] == leg1["tables"] and leg0["tables"]
        for part in ("params", "stats"):
            for k, v in leg0[part].items():
                assert torch.equal(v, leg1[part][k]), f"{part} {k}"
    saved = torch.load(os.path.join(runs["ckpts"], "checkpoint-2.pt"),
                       weights_only=False)["params"]
    for legs in (rank0, rank1):
        assert legs[1]["restored"]["step"] == legs[0]["step"] == 2
        assert legs[1]["step"] == 4
        for k, v in saved.items():
            assert torch.equal(legs[1]["restored"]["params"][k], v), k


def test_two_rank_fit_matches_single_process_fit(runs):
    for ours, ref in zip(runs["ranks"][0]["fit"], runs["single_fit"]):
        assert ours["step"] == ref["step"]
        assert len(ours["tables"]) == len(ref["tables"]) == 1
        for k, v in ref["tables"][0].items():
            got = ours["tables"][0][k]
            assert abs(got - v) <= FIT_TOL["table"] * max(abs(v), 1e-3), \
                f"{k}: {got} vs {v}"
        for part, what in (("params", "param"), ("stats", "stat")):
            _assert_close(ours[part], ref[part], FIT_TOL[what], 0.0, what)


def test_shard_batch_follows_jax_layout_and_round_trips():
    assert TIME_MAJOR_KEYS == jax_mesh.TIME_MAJOR_KEYS
    batch = _take(_window(2, 4, seed=3), [0, 1, 2, 3])
    batch["pad_mask"] = np.array([1, 1, 1, 0], np.int64)
    jmesh = jax_mesh.make_mesh(jax.devices()[:WORLD])
    jbatch = jax_mesh.shard_batch(jmesh, batch)
    shards = [shard_batch(DataMesh(r, WORLD, torch.device("cpu")), batch)
              for r in range(WORLD)]
    for k, v in batch.items():
        axis = 1 if k in TIME_MAJOR_KEYS else 0
        by_device = {s.device: np.asarray(s.data)
                     for s in jbatch[k].addressable_shards}
        for r, shard in enumerate(shards):
            np.testing.assert_array_equal(shard[k].numpy(),
                                          by_device[jax.devices()[r]])
        np.testing.assert_array_equal(
            np.concatenate([s[k].numpy() for s in shards], axis), v)


def test_one_process_mesh_refuses_a_mesh_size_and_reduces_nothing():
    mesh = make_data_mesh(4)
    assert (mesh.rank, mesh.world, mesh.active) == (0, 1, False)
    with pytest.raises(ValueError, match="TPU.MESH.DATA=2 but 1 rank"):
        make_data_mesh(4, max_ranks=2)


def test_init_distributed_picks_the_backend(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        init_distributed("cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert init_distributed("cpu") == torch.device("cpu")
    assert init_distributed("cpu", backend="nccl") == torch.device("cpu")
    assert [c[0] for c in calls] == ["gloo", "nccl"]
    for _, kw in calls:
        assert (kw["rank"], kw["world_size"]) == (1, 2)
        assert kw["init_method"] == "env://"
        assert 0 < kw["timeout"].total_seconds() < 3600
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()

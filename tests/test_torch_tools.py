"""The port's remaining tools against the JAX package on the CPU: the ops
off the model's path, the debugging and benchmark utilities, the serving
planner, the JAX ``.msgpack`` weights read without JAX, and the
``make_splits``, ``demo``, ``benchmark_ops``, ``profile_step`` and
``video_inference --target-fps`` CLIs.

Tolerances: ``cat_fms``, ``dif_fms``, the correlations and the pyramids
1e-5 of the largest value (f32, sums in another order);
``LatencyModel`` and ``select_operating_point`` 1e-9 (the same float64
arithmetic); ``make_splits`` byte for byte; the weights bit for bit;
``demo``'s EPE and 3PE 1e-3 (the same disparities, within the
single-frame model's 2e-3 relative tolerance of tests/test_torch_export.py,
scored by the same metric).
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import serialization

from temporalstereo_tpu import serving as jax_serving
from temporalstereo_tpu.cli import demo as jax_demo
from temporalstereo_tpu.cli import make_splits as jax_make_splits
from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.data import evaluation as jax_evaluation
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.ops import correlation as jax_correlation
from temporalstereo_tpu.ops import cost as jax_cost
from temporalstereo_tpu.training import checkpoint as jax_ckpt
from temporalstereo_tpu.utils import benchmark as jax_benchmark
from temporalstereo_tpu.utils import debug as jax_debug

from temporalstereo_tpu_torch import serving
from temporalstereo_tpu_torch.cli import (benchmark_ops, demo, make_splits,
                                          profile_step, video_inference)
from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.data import build_stereo_dataset, collate
from temporalstereo_tpu_torch.data.png import read_png
from temporalstereo_tpu_torch.data.synthetic import write_kitti2015_split
from temporalstereo_tpu_torch.models import build_model, multi_frame_forward
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.ops import cat_fms, dif_fms
from temporalstereo_tpu_torch.ops import correlation
from temporalstereo_tpu_torch.utils import benchmark, debug, flax_msgpack
from temporalstereo_tpu_torch.utils.checkpoint import load_weights
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
KITTI = str(REPO / "configs" / "kitti2015-multi.yaml")
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]
TOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ours, ref, tol=TOL):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), err


# ------------------------------------------------------------------ ops --

@pytest.mark.parametrize("dense", [True, False], ids=["int", "tensor"])
@pytest.mark.parametrize("name", ["cat_fms", "dif_fms"])
def test_cost_volumes_match_jax(name, dense):
    """Dense integer disparities and per-pixel hypotheses (some past the
    edges); negative features exercise dif_fms' max-cost fill."""
    rng = np.random.RandomState(3)
    ref = rng.randn(2, 6, 10, 8).astype(np.float32)
    tgt = rng.randn(2, 6, 10, 8).astype(np.float32)
    disp = 4 if dense else (rng.rand(2, 4, 6, 10) * 12 - 1).astype(np.float32)
    port_fn = {"cat_fms": cat_fms, "dif_fms": dif_fms}[name]
    with jax.default_matmul_precision("highest"):
        want = getattr(jax_cost, name)(
            jnp.asarray(ref), jnp.asarray(tgt),
            disp if dense else jnp.asarray(disp))
    got = port_fn(torch.from_numpy(ref), torch.from_numpy(tgt),
                  disp if dense else torch.from_numpy(disp))
    _close(got, want)


@pytest.mark.parametrize("kind,patch,dilation",
                         [("2d", 3, 1), ("2d", 3, 2), ("1d", 5, 2)])
def test_patch_correlation_matches_jax(kind, patch, dilation):
    rng = np.random.RandomState(4)
    a = rng.randn(2, 7, 9, 6).astype(np.float32)
    b = rng.randn(2, 7, 9, 6).astype(np.float32)
    want = getattr(jax_correlation, f"correlation{kind}")(
        jnp.asarray(a), jnp.asarray(b), patch, dilation)
    got = getattr(correlation, f"correlation{kind}")(
        torch.from_numpy(a), torch.from_numpy(b), patch, dilation)
    _close(got, want)


def test_correlation_pyramids_match_jax():
    """CorrBlock (positions past both edges) and FlowCorrBlock (an odd
    level size, where the pool drops the remainder)."""
    rng = np.random.RandomState(5)
    f1 = rng.randn(1, 2, 8, 4).astype(np.float32)
    f2 = rng.randn(1, 2, 8, 4).astype(np.float32)
    coords = (rng.rand(1, 2, 8) * 14 - 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_correlation.CorrBlock(jnp.asarray(f1), jnp.asarray(f2),
                                         num_levels=2, radius=2)(
            jnp.asarray(coords))
    got = correlation.CorrBlock(torch.from_numpy(f1), torch.from_numpy(f2),
                                num_levels=2, radius=2)(
        torch.from_numpy(coords))
    _close(got, want)

    g1 = rng.randn(1, 6, 5, 4).astype(np.float32)
    g2 = rng.randn(1, 6, 5, 4).astype(np.float32)
    xy = (rng.rand(1, 6, 5, 2) * 7 - 1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_correlation.FlowCorrBlock(
            jnp.asarray(g1), jnp.asarray(g2), num_levels=2, radius=1)(
            jnp.asarray(xy))
    got = correlation.FlowCorrBlock(torch.from_numpy(g1),
                                    torch.from_numpy(g2), num_levels=2,
                                    radius=1)(torch.from_numpy(xy))
    _close(got, want)


# ---------------------------------------------------------------- utils --

def test_debug_utilities():
    """check_finite agrees with JAX's on the same trees; assert_finite
    names the leaf; nan_guard raises at the operation that makes a NaN,
    a backward included, and passes finite work through; trace writes a
    Chrome trace."""
    trees = [{"a": np.ones(3, np.float32), "b": [np.arange(2)]},
             {"a": np.ones(3, np.float32),
              "b": [np.array([1.0, np.inf], np.float32)]},
             {"x": np.array([np.nan], np.float32)}]
    for tree in trees:
        want = bool(jax_debug.check_finite(jax.tree.map(jnp.asarray, tree)))
        ported = jax.tree.map(torch.from_numpy, tree)
        assert bool(debug.check_finite(ported)) == want
    with pytest.raises(FloatingPointError, match=r"tree\['b'\]\[0\]"):
        debug.assert_finite(jax.tree.map(torch.from_numpy, trees[1]))
    debug.assert_finite(jax.tree.map(torch.from_numpy, trees[0]))

    guarded = debug.nan_guard(lambda x: (x - x) / (x - x))
    with pytest.raises(FloatingPointError, match="div"):
        guarded(torch.ones(2))
    assert torch.equal(debug.nan_guard(torch.exp)(torch.zeros(2)),
                       torch.ones(2))

    def sqrt_grad(x):
        x = x.clone().requires_grad_()
        x.sqrt().sum().backward()
        return x.grad
    with pytest.raises(FloatingPointError):
        debug.nan_guard(sqrt_grad)(torch.tensor([-1.0]))


def test_trace_writes_chrome_trace(tmp_path):
    with debug.trace(str(tmp_path)):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("aten::sum" in e.get("name", "")
               for e in trace["traceEvents"])


def test_benchmark_utilities(capsys):
    """report prints JAX's line; the timers give positive seconds on CPU
    tensors; the device timer and a CUDA graph need a card."""
    msg = benchmark.report("op", 0.0025)
    assert msg == jax_benchmark.report("op", 0.0025)
    assert benchmark.timeTestTemplate is benchmark.time_test
    x = torch.ones(64)
    assert benchmark.time_test(torch.sin, x, iters=3) > 0
    assert benchmark.time_test_fused(torch.sin, x, reps=4, iters=3) > 0
    with pytest.raises(ValueError, match="CUDA graph"):
        benchmark.time_test_fused(torch.sin, x, graph=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmark.time_test_device(torch.sin, x)


# -------------------------------------------------------------- planner --

def _jax_max_streams(note):
    return int(re.search(r"serve <= (\d+) stream", note).group(1))


@pytest.mark.parametrize("table", ["port", "jax"])
def test_latency_model_and_operating_point_match_jax(table):
    """The fit, its parameters and walls at every stream count 1..12
    (interpolated and extrapolated), and the operating point for targets
    that are met and that are not, on the port's default table's
    measurements and on the JAX package's."""
    if table == "port":
        points = [(s, c, serving.H100_SXM_700W.wall_ms(s, c))
                  for s in (1, 2, 4, 8) for c in (1, 2, 8)]
    else:
        points = [(s, c, jax_serving.V5E_TUNNEL.wall_ms(s, c))
                  for s in (1, 2, 4, 8) for c in (2, 8)]
    ours = serving.LatencyModel.fit(points, name="t")
    ref = jax_serving.LatencyModel.fit(points, name="t")
    for s in range(1, 13):
        for a, b in zip(ours.params(s), ref.params(s)):
            assert abs(a - b) <= 1e-9 * max(abs(b), 1.0)
        for c in (1, 3, 8, 32):
            assert abs(ours.wall_ms(s, c) - ref.wall_ms(s, c)) <= 1e-9 * abs(
                ref.wall_ms(s, c))
    infeasible = 0
    for s in (1, 2, 3, 4, 8, 12):
        for fps in (5.0, 15.0, 30.0, 60.0, 95.0, 400.0):
            got = serving.select_operating_point(s, fps, ours)
            want = jax_serving.select_operating_point(s, fps, ref)
            for key in ("chunk", "fps_per_stream", "latency_ms", "feasible"):
                assert got[key] == want[key], (s, fps, key)
            if not want["feasible"]:
                infeasible += 1
                assert got["max_streams"] == _jax_max_streams(want["note"])
                assert f"serve <= {got['max_streams']} stream" in got["note"]
    assert infeasible > 0


def test_video_inference_plans_operating_point(tmp_path, capsys):
    """--target-fps/--streams against a JSON table print the operating point
    or the warning, and --export-bundle records it in the bundle's meta."""
    from tests.test_torch_cli import _sequence

    seq = tmp_path / "seq"
    seq.mkdir()
    _sequence(seq, 1, 96, 128, 96, 128, np.random.RandomState(2))
    table = [(s, c, 2.0 + c * 10.0 * s) for s in (1, 2, 4) for c in (1, 8)]
    (tmp_path / "t.json").write_text(json.dumps(
        {"name": "toy", "measurements": table}))
    lm = serving.LatencyModel.fit(table, name="toy")
    for fps, streams in ((30.0, 2), (30.0, 4)):
        bundle = tmp_path / f"b{streams}.json"
        video_inference.main([
            "--config-file", KITTI, "--data-root", str(seq), "--log-dir",
            str(tmp_path / "out"), "--height", "96", "--width", "128",
            "--device", "cpu", "--target-fps", str(fps), "--streams",
            str(streams), "--latency-model", str(tmp_path / "t.json"),
            "--export-bundle", str(bundle), *TINY])
        printed = capsys.readouterr().out
        want = serving.select_operating_point(streams, fps, lm)
        if want["feasible"]:
            assert (f"operating point: chunk={want['chunk']} -> "
                    f"{want['fps_per_stream']} fps/stream") in printed
        else:
            assert f"WARNING: {want['note']}" in printed
        meta = json.loads(bundle.read_text())
        assert meta["operating_point"] == {**want, "target_fps": fps,
                                           "streams": streams}
    assert serving.select_operating_point(4, 30.0, lm)["feasible"] is False
    assert serving.LATENCY_MODELS["H100_SXM_700W"] is serving.H100_SXM_700W


# ---------------------------------------------------------- make_splits --

def _png(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"png")


def _tree(root, dataset):
    if dataset == "sceneflow":
        for scene in ("0000", "0001"):
            for f in range(3):
                for side in ("left", "right"):
                    _png(root / "frames_cleanpass" / "TRAIN" / "A" / scene
                         / side / f"{f:04d}.png")
                _png(root / "disparity" / "TRAIN" / "A" / scene / "left"
                     / f"{f:04d}.pfm")
            _png(root / "camera_data" / "TRAIN" / "A" / scene
                 / "camera_data.txt")
        return ["sceneflow", "--data-root", str(root), "--frame-idxs",
                "-1", "0"]
    if dataset == "kitti2015":
        for sid in ("000000", "000001"):
            for ff in range(8, 11):
                for view in ("image_2", "image_3"):
                    _png(root / "training" / view / f"{sid}_{ff:02d}.png")
            _png(root / "training" / "disp_occ_0" / f"{sid}_10.png")
            _png(root / "training" / "poses" / f"{sid}.txt")
        _png(root / "training" / "calib_cam_to_cam" / "000000.txt")
        return ["kitti2015", "--data-root", str(root), "--frame-idxs=-2..0"]
    for i in range(4):
        for side in ("left", "right"):
            _png(root / "seq" / side / f"{i:06d}.png")
        if i != 2:
            _png(root / "seq" / "disp" / f"{i:06d}.npy")
    _png(root / "seq" / "pose_left.txt")
    return ["sequence", "--left-dir", str(root / "seq" / "left"),
            "--right-dir", str(root / "seq" / "right"), "--disp-dir",
            str(root / "seq" / "disp"), "--pose-file",
            str(root / "seq" / "pose_left.txt"), "--frame-idxs", "-1", "0"]


@pytest.mark.parametrize("dataset", ["sceneflow", "kitti2015", "sequence"])
def test_make_splits_byte_identical_to_jax(dataset, tmp_path, monkeypatch):
    args = _tree(tmp_path / "data", dataset)
    monkeypatch.setattr(sys, "argv", ["make_splits", *args, "--output",
                                      str(tmp_path / "jax.json")])
    jax_make_splits.main()
    make_splits.main([*args, "--output", str(tmp_path / "port.json")])
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert len(json.loads(want)) > 0


# -------------------------------------------------------------- weights --

def _jax_tiny():
    return jax_build_model(jax_get_cfg(KITTI, TINY), dtype=None)


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """A JAX ``save_weights`` file of the tiny temporal model: numpy draws
    over its variable shapes (tests/test_torch_train_step.py's recipe),
    the stem's kernel stored as bf16 and every leaf above 64 KiB chunked
    (flax's chunk limit lowered for the write) -> (path, params as saved,
    batch_stats, variable shapes)."""
    x = jax.ShapeDtypeStruct((1, 96, 128, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r, x: _jax_tiny().init({"params": r}, x, x, None, False),
        jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(17)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.rand(*s.shape) * 0.5 + 0.75
        elif name in ("bias", "mean"):
            v = rng.randn(*s.shape) * 0.1
        else:
            v = rng.randn(*s.shape) * 0.1
        return np.asarray(v, np.float32)
    params, stats = (jax.tree_util.tree_map_with_path(leaf, shapes[c])
                     for c in ("params", "batch_stats"))
    stem = params["backbone"]["conv_stem"]["Conv_0"]
    stem["kernel"] = np.asarray(jnp.asarray(stem["kernel"], jnp.bfloat16))
    sizes = [v.nbytes for v in jax.tree.leaves(params)]
    assert max(sizes) > 65536
    path = tmp_path_factory.mktemp("weights") / "tiny.msgpack"
    limit = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 65536
    try:
        jax_ckpt.save_weights(str(path), params, stats)
    finally:
        serialization.MAX_CHUNK_SIZE = limit
    return path, params, stats, shapes


def _widened(params):
    """The tree as JAX's warm start takes it into f32 variables."""
    return jax.tree.map(lambda v: np.asarray(v, np.float32), params)


def test_msgpack_reader_matches_flax():
    """Every MessagePack type flax writes, chunked arrays, bf16, complex
    and numpy scalars; and the plain reader against the msgpack package
    on values of every width."""
    import msgpack

    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": jnp.asarray([1.5, -2.25, 3e-3, -0.0], jnp.bfloat16),
            "c": {"d": np.int64(-7), "e": np.array(3.5, np.float64),
                  "big": np.arange(5000, dtype=np.int32)},
            "f": 1 + 2j, "g": -1, "h": 300, "i": -40000, "j": 2 ** 40,
            "k": "x" * 40, "l": None, "m": True, "n": b"\x00\x01",
            "o": [1.25, -3, "s"]}
    limit = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 4000
    try:
        data = serialization.to_bytes(tree)
    finally:
        serialization.MAX_CHUNK_SIZE = limit
    assert b"__msgpack_chunked_array__" in data
    got, want = flax_msgpack.restore(data), serialization.msgpack_restore(
        data)

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif hasattr(b, "dtype"):
            y = np.asarray(b)
            if y.dtype.name == "bfloat16":
                y = y.astype(np.float32)
            assert np.asarray(a).dtype == y.dtype
            np.testing.assert_array_equal(a, y)
        else:
            assert type(a) is type(b) and a == b
    same(got, want)

    values = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
              -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
              -2 ** 63, 0.5, 1e300, "", "é" * 20, "x" * 300, "y" * 70000,
              b"", b"z" * 300, b"w" * 70000, list(range(20)),
              {str(i): i for i in range(20)}, msgpack.ExtType(1, b"")]
    for v in values:
        packed = msgpack.packb(v, use_bin_type=True)
        if isinstance(v, msgpack.ExtType):
            with pytest.raises(ValueError):
                flax_msgpack.unpackb(packed)
        else:
            assert flax_msgpack.unpackb(packed) == msgpack.unpackb(packed)
    packed = msgpack.packb(np.float32(0.1).item(), use_single_float=True)
    assert flax_msgpack.unpackb(packed) == msgpack.unpackb(packed)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(msgpack.packb("abc")[:-1])


def test_msgpack_weights_load_without_jax(jax_weights, tmp_path):
    """In a process that imports neither JAX, flax nor msgpack, the port
    reads the JAX weights file into the state_dict that
    ``state_dict_from_jax`` makes of the same variables, bit for bit, and
    ``load_weights`` loads every tensor of the tiny model."""
    path, params, stats, _ = jax_weights
    out = tmp_path / "sd.pt"
    code = (
        "import sys, torch\n"
        "from temporalstereo_tpu_torch.config import get_cfg\n"
        "from temporalstereo_tpu_torch.models import build_model\n"
        "from temporalstereo_tpu_torch.utils.checkpoint import (\n"
        "    load_weights, read_state_dict)\n"
        f"sd = read_state_dict({str(path)!r})\n"
        f"model = build_model(get_cfg({KITTI!r}, {TINY!r}), device='cpu')\n"
        f"n = load_weights(model, {str(path)!r})\n"
        "assert n == len(model.state_dict()) == len(sd), (n, len(sd))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'msgpack',\n"
        "                                    'ml_dtypes', 'temporalstereo_tpu'))\n"
        "assert not bad, bad\n"
        f"torch.save(sd, {str(out)!r})\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    got = torch.load(out, weights_only=True)
    want = state_dict_from_jax(_widened(params), stats, TINY_GROUPS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_msgpack_partial_weights_merge_like_jax(jax_weights, tmp_path):
    """A weights file without the precise stage, one BatchNorm's
    statistics and with one reshaped kernel merges into a model as JAX's
    ``load_any_weights`` merges it into fresh variables: the same tensors
    taken (JAX's count plus the BatchNorms' counters), the rest kept."""
    path, params, stats, shapes = jax_weights
    params = _widened(params)
    part_p = jax.tree.map(lambda v: v, params)
    part_s = jax.tree.map(lambda v: v, stats)
    del part_p["aggregation"]["precise"], part_s["aggregation"]["precise"]
    del part_s["backbone"]["conv_stem"]
    conv32 = part_p["backbone"]["conv32"]["Conv_0"]
    conv32["kernel"] = conv32["kernel"][:, :, :, :-1]
    partial = tmp_path / "partial.msgpack"
    jax_ckpt.save_weights(str(partial), part_p, part_s)

    rng = np.random.RandomState(23)
    fresh = {c: jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes[c])
        for c in ("params", "batch_stats")}
    merged, n = jax_ckpt.load_any_weights(fresh, str(partial))

    model = build_model(get_cfg(KITTI, TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        fresh["params"], fresh["batch_stats"], TINY_GROUPS))
    loaded = load_weights(model, str(partial))
    want = state_dict_from_jax(
        jax.tree.map(np.asarray, merged["params"]),
        jax.tree.map(np.asarray, merged["batch_stats"]), TINY_GROUPS)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    counters = sum(k.endswith("num_batches_tracked")
                   for k in flax_msgpack.read_state_dict(str(partial)))
    assert 0 < n < len(jax.tree.leaves(fresh))
    assert loaded == n + counters


# ----------------------------------------------------------------- demo --

class _JaxShim:
    """``jax`` as the JAX demo under test sees it: its random init, every
    leaf of which the weights file replaces (the count is checked), is
    zeros of the variables' shapes; its forward compiles with XLA's CPU
    optimisations off and keeps its disparities; the persistent
    compilation cache it would turn on stays off."""

    def __init__(self, shapes, outputs):
        self._shapes, self._outputs, self._calls = shapes, outputs, 0
        self.config = type("Config", (), {"update": staticmethod(
            lambda *a, **k: None)})

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        self._calls += 1
        if self._calls == 1:
            return lambda *a: jax.tree.map(
                lambda s: jnp.zeros(s.shape, s.dtype), self._shapes)
        jitted = jax.jit(fn, compiler_options=FAST_COMPILE, **kw)

        def run(*a):
            out = jitted(*a)
            self._outputs.append(np.asarray(out))
            return out
        return run


def test_demo_matches_jax(jax_weights, tmp_path, monkeypatch, capsys):
    """The port's demo and the JAX demo on the same synthetic KITTI 2015
    split (two samples of one frame, 96x128 crops of 120x200 frames: one
    frame keeps the JAX demo's trace and compile within the time a test
    may take; tests/test_torch_eval.py holds the temporal window) and the
    same ``.msgpack`` weights: EPE and 3PE per sample within 1e-3, panels
    of the same shape; the port's model loaded from the file computes the
    JAX demo's disparities (2e-3 of their mean, test_torch_export's
    single-frame tolerance)."""
    path, _, _, shapes = jax_weights
    ann = write_kitti2015_split(str(tmp_path / "k"), 2, [0], h=120, w=200)
    opts = ["DATA.VAL.DATA_ROOT", str(tmp_path / "k"), "DATA.VAL.ANNFILE",
            ann, "DATA.VAL.FRAME_IDXS", "[0]", "DATA.VAL.HEIGHT", "96",
            "DATA.VAL.WIDTH", "128", *TINY]

    outputs, jax_errors = [], []
    calc_error = jax_evaluation.calc_error

    def spy(*a, **k):
        err = calc_error(*a, **k)
        jax_errors.append((float(err["epe"]), float(err["3px"])))
        return err
    monkeypatch.setattr(jax_evaluation, "calc_error", spy)
    monkeypatch.setattr(jax_demo, "jax", _JaxShim(shapes, outputs))
    monkeypatch.setattr(sys, "argv", [
        "demo", "--config-file", KITTI, "--checkpoint", str(path),
        "--output-dir", str(tmp_path / "jax"), *opts])
    jax_demo.main()
    jax_printed = capsys.readouterr().out
    n_leaves = len(jax.tree.leaves(shapes))
    assert f"loaded {n_leaves} tensors" in jax_printed

    summary = demo.main(["--config-file", KITTI, "--checkpoint", str(path),
                         "--output-dir", str(tmp_path / "port"),
                         "--device", "cpu", *opts])
    assert summary["samples"] == len(jax_errors) == 2
    for (epe, p3), e, p in zip(jax_errors, summary["epe"], summary["3px"]):
        assert abs(e - epe) <= 1e-3 and abs(p - p3) <= 1e-3
    for i in range(2):
        name = f"demo_{i:04d}.png"
        want = np.asarray(Image.open(tmp_path / "jax" / name)).shape
        assert read_png(str(tmp_path / "port" / name)).shape == want

    cfg = get_cfg(KITTI, opts)
    model = build_model(cfg, device="cpu")
    load_weights(model, str(path))
    dataset = build_stereo_dataset(cfg.DATA.VAL, "val")
    for i, want in enumerate(outputs):
        batch = {k: torch.from_numpy(v) for k, v in
                 collate([dataset[i]]).items()}
        with torch.no_grad():
            got = multi_frame_forward(model, batch)[0]["disps"][0].numpy()
        rel = np.abs(got - want).max() / (np.abs(want).mean() + 1e-6)
        assert rel < 2e-3, rel


# ------------------------------------------------------- tool CLIs, CPU --

def test_benchmark_ops_cli_on_cpu(capsys):
    """Every op runs; the JSON line is the result; the reference's figures
    appear only at the KITTI size they were taken at, with their
    hardware; no kernel launches on the CPU."""
    result = benchmark_ops.main(["--device", "cpu", "--height", "64",
                                 "--width", "128"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    assert set(result["ops"]) >= {"block_cost_1_4", "cat_fms_dense",
                                  "dif_fms_dense", "correlation2d",
                                  "softsplat_1_8"}
    assert all(op["ms"] > 0 and op["reference"] is None
               for op in result["ops"].values())
    assert result["card"] is None and not any(result["launches"].values())
    assert {k: v[1] for k, v in benchmark_ops.REFERENCE.items()} == {
        "block_cost_1_4": "GTX 3090 (reference)",
        "cat_fms_dense": "GTX 3090 (reference)",
        "dif_fms_dense": "GTX 3090 (reference)",
        "correlation2d": "unstated GPU (reference)"}


def test_profile_step_cli_on_cpu(capsys):
    """A streamed frame of the tiny model: the scopes hold the model's
    modules, the summary line is printed."""
    summary = profile_step.main(["--temporal", "--device", "cpu",
                                 "--height", "96", "--width", "128",
                                 "--iters", "1", "--top", "5", *TINY])
    printed = capsys.readouterr().out
    assert printed.strip().splitlines()[-1].startswith("profile summary: ")
    assert summary["mode"] == "stream" and summary["busy_share"] is None
    assert {"backbone", "aggregation.precise"} <= set(summary["scopes"])
    assert len(summary["top"]) == 5 and summary["wall_ms"] > 0

"""The port's reader of the JAX package's orbax checkpoints (utils/orbax.py)
against orbax and tensorstore, which only the tests import.

Checkpoints are written here by the JAX package's
``training/checkpoint.py:CheckpointManager`` from a ``TrainState`` of the
tiny model (the variables of tests/test_torch_model.py's recipe, the stem's
kernel in bf16, the JAX optimizer's state): two steps, and one with SWA
and ``extra``.  The port reads every leaf bit-equal to orbax's restore (bf16
widened to f32), in a process that imports none of JAX, flax, orbax,
tensorstore or zstandard; its OCDBT listing equals tensorstore's, also for
a store with interior B+tree nodes; ``load_any_weights`` on the directory
equals the ``.msgpack`` path for the same weights; and the port's forward
after that load meets JAX's after its own ``load_any_weights`` at the
single-frame tolerance of tests/test_torch_model.py.
"""
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import tensorstore as ts
import torch

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.training import checkpoint as jax_ckpt
from temporalstereo_tpu.training.optim import build_optimizer
from temporalstereo_tpu.training.state import TrainState

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import build_model
from temporalstereo_tpu_torch.training.checkpoint import load_any_weights
from temporalstereo_tpu_torch.training.state import master_copies
from temporalstereo_tpu_torch.utils import orbax
from temporalstereo_tpu_torch.utils.checkpoint import load_weights

REPO = Path(__file__).resolve().parents[1]
TINY = ["MODEL.BACKBONE.VARIANT", "tiny",
        "MODEL.AGGREGATION.COARSE.C", "8",
        "MODEL.AGGREGATION.FINE.C", "8",
        "MODEL.AGGREGATION.PRECISE.C", "8",
        "TRAINER.PRECISION", "f32"]
SINGLE_TOL = 2e-3               # tests/test_torch_model.py
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
H, W = 64, 96
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "tensorstore", "zstandard",
             "ml_dtypes", "temporalstereo_tpu")


def _variables(jmodel, seed):
    """Numpy draws over the JAX model's variable shapes (kernels N(0,
    1/fan_in), BatchNorm scales and variances around 1, small biases and
    means), the stem's kernel rounded to bf16."""
    x = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init({"params": r}, x, x, None, False),
        jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.rand(*s.shape) * 0.5 + 0.75
        else:
            v = rng.randn(*s.shape) * 0.1
        return np.asarray(v, np.float32)
    params, stats = (jax.tree_util.tree_map_with_path(leaf, shapes[c])
                     for c in ("params", "batch_stats"))
    stem = params["backbone"]["conv_stem"]["Conv_0"]
    stem["kernel"] = jnp.asarray(stem["kernel"], jnp.bfloat16)
    return params, stats


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """JAX CheckpointManager directories: "plain" (steps 3 and 5, the
    second with other weights and hparams) and "swa" (step 7 with SWA and
    extra), a ``save_weights`` file of step 5's weights -> (paths, the
    weights of step 5, the JAX model)."""
    root = tmp_path_factory.mktemp("orbax")
    jcfg = jax_get_cfg(opts=TINY)
    jmodel = jax_build_model(jcfg, dtype=None)
    params, stats = _variables(jmodel, seed=31)
    tx = build_optimizer(jcfg, 10)
    plain = jax_ckpt.CheckpointManager(str(root / "plain"))
    plain.save(3, TrainState.create(params, stats, tx).replace(
        step=jnp.asarray(3, jnp.int32)))
    params5 = jax.tree.map(lambda v: (v * 1.5).astype(v.dtype), params)
    state5 = TrainState.create(params5, stats, tx)
    plain.save(5, state5.replace(step=jnp.asarray(5, jnp.int32)),
               hparams={"MODEL": {"BACKBONE": {"VARIANT": "tiny"}}})
    swa = TrainState.create(params, stats, tx, with_swa=True)
    swa = swa.replace(step=jnp.asarray(7, jnp.int32),
                      swa_params=jax.tree.map(lambda v: v * 0.5, params),
                      swa_count=jnp.asarray(2, jnp.int32))
    jax_ckpt.CheckpointManager(str(root / "swa")).save(
        7, swa, extra={"epoch": 2, "val_epe": 1.5})
    weights = root / "step5.msgpack"
    jax_ckpt.save_weights(str(weights), params5, stats)
    return ({"plain": root / "plain", "swa": root / "swa",
             "msgpack": weights}, params5, stats, jmodel)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)[0]


def _orbax_restore(directory, step):
    return ocp.CheckpointManager(str(directory)).restore(step)


def test_reads_every_leaf_bit_equal_without_jax_orbax_tensorstore(
        saved, tmp_path):
    """In a process that imports none of JAX, flax, orbax, tensorstore or
    zstandard, the port reads each checkpoint's latest step; every leaf is
    bit-equal to orbax's restore (bf16 widened), sequences are tuples, and
    the steps and hparams are orbax's."""
    paths = saved[0]
    out = tmp_path / "trees.pkl"
    code = (
        "import pickle, sys\n"
        "from temporalstereo_tpu_torch.utils import orbax\n"
        "trees = {}\n"
        f"for name, d in {[(k, str(paths[k])) for k in ('plain', 'swa')]!r}:\n"
        "    trees[name] = (orbax.all_steps(d), orbax.read_checkpoint(d),\n"
        "                   orbax.load_hparams(d))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"pickle.dump(trees, open({str(out)!r}, 'wb'))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    with open(out, "rb") as f:
        trees = pickle.load(f)
    for name, step in (("plain", 5), ("swa", 7)):
        steps, ours, hparams = trees[name]
        mgr = jax_ckpt.CheckpointManager(str(paths[name]))
        assert steps == list(mgr.mgr.all_steps()) and steps[-1] == step
        assert hparams == mgr.load_hparams()
        theirs = _orbax_restore(paths[name], step)
        assert sorted(ours) == sorted(theirs)
        assert isinstance(ours["opt_state"], tuple)
        flat_ours, flat_theirs = _flat(ours), _flat(theirs)
        assert [p for p, _ in flat_ours] == [p for p, _ in flat_theirs]
        for (path, a), (_, b) in zip(flat_ours, flat_theirs):
            b = np.asarray(b)
            if b.dtype == jnp.bfloat16:
                b = b.astype(np.float32)
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
    swa = trees["swa"][1]
    assert int(swa["swa_count"]) == 2 and set(swa["extra"]) == {"epoch",
                                                                 "val_epe"}


def _tensorstore_items(root):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}"}).result()
    return {bytes(k): bytes(kv.read(k).result().value)
            for k in kv.list().result()}


def test_ocdbt_listing_matches_tensorstore(saved, tmp_path):
    """The same keys and value bytes as tensorstore's OCDBT driver: the
    checkpoints' stores (a top-level tree over ocdbt.process_0/, inline and
    data-file values), and a store of small nodes, many versions and
    interior B+tree nodes written by tensorstore."""
    paths = saved[0]
    roots = [paths["plain"] / "5" / "default", paths["swa"] / "7" / "default"]
    store = tmp_path / "ocdbt"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{store}",
                          "config": {"max_decoded_node_bytes": 512,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.RandomState(5)
    for t in range(6):
        with ts.Transaction() as txn:
            for _ in range(40):
                key = f"k/{t}/{rng.randint(500):03d}/" + "x" * rng.randint(4)
                kv.with_transaction(txn).write(
                    key, rng.bytes(rng.randint(1, 40))).result()
    roots.append(store)
    for root in roots:
        ours = orbax.OcdbtReader(root).items()
        assert ours == _tensorstore_items(root), root
    assert orbax.OcdbtReader(store)._root[3] > 0     # interior nodes


def test_committed_fixture_matches_its_seed():
    """tests/data/orbax_fixture (scripts/make_orbax_fixture.py) read by the
    port equals the script's numpy regeneration bit for bit, and orbax's
    own restore of it."""
    spec = importlib.util.spec_from_file_location(
        "make_orbax_fixture", REPO / "scripts" / "make_orbax_fixture.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fixture = script.OUT
    ours = orbax.read_checkpoint(fixture)
    want = script.fixture_tree()
    theirs = _orbax_restore(fixture, script.STEP)
    assert orbax.latest_step(fixture) == script.STEP
    assert ours["opt_state"][2] == ()
    flat = _flat(ours)
    assert [p for p, _ in flat] == [p for p, _ in _flat(want)]
    for (path, a), (_, b), (_, c) in zip(flat, _flat(want), _flat(theirs)):
        c = np.asarray(c)
        if c.dtype == jnp.bfloat16:
            c = c.astype(np.float32)
        for ref in (np.asarray(b), c):
            assert a.dtype == ref.dtype and a.shape == ref.shape, path
            assert a.tobytes() == ref.tobytes(), path
    size = sum(p.stat().st_size for p in fixture.rglob("*") if p.is_file())
    assert size <= 300 * 1024


def test_malformed_checkpoints_raise(tmp_path):
    """A flipped byte in a manifest, a cut data file and a temporary step
    directory: CRC and bounds errors, and orbax's step naming."""
    spec = importlib.util.spec_from_file_location(
        "make_orbax_fixture", REPO / "scripts" / "make_orbax_fixture.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    root = tmp_path / "ckpt"
    shutil.copytree(script.OUT, root)
    (root / "13.orbax-checkpoint-tmp-99").mkdir()
    (root / "14").mkdir()                            # not finished
    assert orbax.all_steps(root) == [script.STEP]
    manifest = root / str(script.STEP) / "default" / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[20] ^= 4
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        orbax.read_checkpoint(root)
    data[20] ^= 4
    manifest.write_bytes(bytes(data))
    biggest = max((p for p in (root / str(script.STEP)).rglob("d/*")),
                  key=lambda p: p.stat().st_size)
    biggest.write_bytes(biggest.read_bytes()[:biggest.stat().st_size // 2])
    with pytest.raises(ValueError):
        orbax.read_checkpoint(root)
    with pytest.raises(FileNotFoundError):
        load_weights(build_model(get_cfg(opts=TINY), device="cpu"),
                     str(tmp_path))


def test_load_any_weights_orbax_equals_msgpack(saved):
    """The port's warm start from the orbax directory (its latest step)
    takes the same tensors as from the ``.msgpack`` of the same weights,
    every tensor of the tiny model."""
    paths = saved[0]
    model = build_model(get_cfg(opts=TINY), device="cpu", seed=1)
    params, stats = master_copies(model)
    from_dir = load_any_weights(params, stats, str(paths["plain"]))
    from_file = load_any_weights(params, stats, str(paths["msgpack"]))
    assert from_dir[2] == from_file[2] == len(params) + len(stats)
    for a, b in zip(from_dir[:2], from_file[:2]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_forward_after_orbax_load_matches_jax(saved):
    """The port's model loaded from the orbax directory (``load_weights``)
    against the JAX model after JAX's ``load_any_weights`` of the same
    directory: the single-frame forward at tests/test_torch_model.py's
    tolerance."""
    paths, _, _, jmodel = saved
    x = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda r, x: jmodel.init({"params": r}, x, x, None, False),
        jax.random.PRNGKey(0), x)
    fresh = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, n = jax_ckpt.load_any_weights(fresh, str(paths["plain"]))
    assert n == len(jax.tree.leaves(fresh))
    model = build_model(get_cfg(opts=TINY), device="cpu", seed=2)
    assert load_weights(model, str(paths["plain"])) == len(
        model.state_dict())
    rng = np.random.RandomState(4)
    left, right = (rng.rand(1, H, W, 3).astype(np.float32) for _ in range(2))
    with jax.default_matmul_precision("highest"):
        jout, _ = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, None, False),
                          compiler_options=FAST_COMPILE)(
            variables, jnp.asarray(left), jnp.asarray(right))
    with torch.inference_mode():
        tout, _ = model(torch.from_numpy(left), torch.from_numpy(right))
    for i, (j, t) in enumerate(zip(jout["disps"], tout["disps"])):
        j = np.asarray(j, np.float64)
        rel = np.abs(t.numpy() - j).max() / (np.abs(j).mean() + 1e-6)
        assert rel < SINGLE_TOL, f"disparity {i}: rel={rel:.2e}"

"""The port's serving slice (temporalstereo_tpu_torch/serving.py and
utils/fold_bn.py) against the JAX package's serving.py and utils/fold_bn.py
on the CPU, tiny model.

The JAX variables come from ``jax.eval_shape`` of the tiny model's init,
filled from a numpy seed with non-trivial BatchNorm statistics (positive
variances); no JAX function is jitted.  Tolerances: folded weights and
biases 1e-6 relative (both sides fold in float64 and round once to f32);
the folded model against the unfolded one 2e-3 relative, the single-frame
model tolerance of tests/test_torch_model.py (the fold reorders the f32
rounding, and the cascade's top-k amplifies it near ties); bf16 casts
bit-equal; the CPU bundle bit-equal to ``streaming_step``, which it calls.
"""
import numpy as np
import pytest
import torch

from temporalstereo_tpu.config import get_cfg as jax_get_cfg
from temporalstereo_tpu.models import build_model as jax_build_model
from temporalstereo_tpu.serving import _stage_list as jax_stage_list
from temporalstereo_tpu.serving import cast_params_bf16 as jax_cast_bf16
from temporalstereo_tpu.utils.fold_bn import (
    fold_batch_norms as jax_fold_batch_norms)
from temporalstereo_tpu.utils.torch_export import save_reference_checkpoint

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.models import (backbone_memory_shapes,
                                             build_model, init_prev_info,
                                             streaming_step)
from temporalstereo_tpu_torch.models.backbone import TINY_GROUPS
from temporalstereo_tpu_torch.ops.sampling import (
    fractional_disparity_samples)
from temporalstereo_tpu_torch.serving import (
    StreamingBundle, bundle_meta, cast_params_bf16, export_streaming_bundle,
    load_streaming_bundle, model_identity_hash, stage_list)
from temporalstereo_tpu_torch.utils.checkpoint import load_weights
from temporalstereo_tpu_torch.utils.convert import state_dict_from_jax
from temporalstereo_tpu_torch.utils.fold_bn import fold_batch_norms

from tests.test_torch_model import TEMPORAL, TINY, _jax_variables, _rel

FOLD_TOL = 1e-6
SINGLE_TOL = 2e-3
H, W = 96, 128
OPTS = TINY + TEMPORAL
BF16 = OPTS + ["TRAINER.PRECISION", "bf16"]
OTHER_MAP = OPTS + ["MODEL.LOCAL_MAP_SIZE", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny model's small ops cost more CPU spread over threads than
    on one, and the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_variables():
    jmodel = jax_build_model(jax_get_cfg(opts=OPTS), dtype=None)
    return _jax_variables(jmodel, H, W, seed=41)


def _port_model(variables, opts=OPTS):
    model = build_model(get_cfg(opts=opts), device="cpu")
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], TINY_GROUPS),
        strict=True)
    return model


# the convolution before each named BatchNorm of the backbone's blocks
_BLOCK_CONVS = {"er": {"bn1": "conv_exp", "bn2": "conv_pwl"},
                "ir": {"bn1": "conv_pw", "bn2": "conv_dw", "bn3": "conv_pwl"}}


def _conv_of(bn: str, state) -> str:
    """The name of the convolution that a folded BatchNorm followed."""
    head, _, last = bn.rpartition(".")
    if last == "norm":
        return head
    if last.isdigit():
        return f"{head}.{int(last) - 1}"
    if head == "backbone":
        return "backbone.conv_stem"
    kind = "er" if f"{head}.conv_exp.weight" in state else "ir"
    return f"{head}.{_BLOCK_CONVS[kind][last]}"


def test_fold_matches_jax_fold(jax_variables):
    """(a) JAX fold then conversion against the port's fold of the
    converted weights: every folded weight and bias, the same count."""
    jfolded, paths = jax_fold_batch_norms(jax_variables)
    ref = state_dict_from_jax(jfolded["params"], jfolded["batch_stats"],
                              TINY_GROUPS)
    model = _port_model(jax_variables)
    unfolded = dict(model.state_dict())
    _, names = fold_batch_norms(model)
    assert len(names) == len(paths) > 0
    state = model.state_dict()
    folded = set()
    for bn in names:
        conv = _conv_of(bn, unfolded)
        for ours, theirs in ((f"{conv}.weight", f"{conv}.weight"),
                             (f"{conv}.bias", f"{bn}.bias")):
            got, want = state[ours].numpy(), ref[theirs].numpy()
            np.testing.assert_allclose(
                got, want, rtol=FOLD_TOL,
                atol=FOLD_TOL * np.abs(want).max(), err_msg=ours)
            folded.add(ours)
        assert not any(k.startswith(f"{bn}.") for k in state), bn
    # the rest of the state is untouched
    for k, v in state.items():
        if k not in folded:
            np.testing.assert_array_equal(v.numpy(), ref[k].numpy(),
                                          err_msg=k)


def _geometry():
    K = torch.tensor([[[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]]])
    T = torch.eye(4)[None].clone()
    T[0, 0, 3], T[0, 2, 3] = 0.03, -0.05
    return K, torch.full((1,), 2.0), T


def _frames(n, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand((1, H, W, 3), generator=g),
             torch.rand((1, H, W, 3), generator=g)) for _ in range(n)]


def _stream(model, frames):
    K, bl, T = _geometry()
    prev = init_prev_info(model, 1, (H, W),
                          backbone_memory_shapes(model.backbone_cfg, (H, W)),
                          2, local_map_channels=0)
    outs = []
    for left, right in frames:
        out, prev = streaming_step(model, left, right, prev, K, bl, T)
        outs.append(out["disps"])
    return outs


def test_folded_model_matches_unfolded(jax_variables):
    """(b) In eval, one frame without the state and three streamed frames."""
    model = _port_model(jax_variables)
    folded, _ = fold_batch_norms(_port_model(jax_variables))
    frames = _frames(3, seed=42)
    with torch.inference_mode():
        single = [m(*frames[0])[0]["disps"] for m in (model, folded)]
    for f, (ref, got) in enumerate(zip(_stream(model, frames),
                                       _stream(folded, frames))):
        for i, (r, g) in enumerate(zip(ref, got)):
            rel = _rel(g.numpy(), r.numpy())
            assert rel < SINGLE_TOL, f"frame {f} disparity {i}: {rel:.2e}"
    for i, (r, g) in enumerate(zip(*single)):
        rel = _rel(g.numpy(), r.numpy())
        assert rel < SINGLE_TOL, f"single frame disparity {i}: {rel:.2e}"


def test_cast_params_bf16_matches_jax(jax_variables):
    """(c) Every parameter bf16 and bit-equal to the JAX cast; the running
    statistics stay f32 and untouched; in a bf16 and in an f32 model."""
    ref = state_dict_from_jax(jax_cast_bf16(jax_variables)["params"],
                              jax_variables["batch_stats"], TINY_GROUPS)
    model = cast_params_bf16(_port_model(jax_variables, BF16))
    params = dict(model.named_parameters())
    for k, v in model.state_dict().items():
        want = ref[k].numpy()
        if k in params:
            assert v.dtype == torch.bfloat16, k
        elif v.is_floating_point():
            assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.float().numpy() if
                                      v.is_floating_point() else v.numpy(),
                                      want, err_msg=k)
    # an f32 model takes the same cast (its layers take each weight in f32
    # where they use it: tests/test_torch_faults.py)
    f32 = cast_params_bf16(_port_model(jax_variables))
    for k, v in f32.named_parameters():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.detach().float().numpy(),
                                      ref[k].numpy(), err_msg=k)


def test_model_identity_hash():
    """(d) Equal for two builds; another local map, type or fold differs."""
    def build(opts=OPTS, seed=0):
        return build_model(get_cfg(opts=opts), device="cpu", seed=seed)
    base = model_identity_hash(build())
    assert model_identity_hash(build(seed=1)) == base
    assert model_identity_hash(build(OTHER_MAP)) != base
    assert model_identity_hash(build(BF16)) != base
    assert model_identity_hash(fold_batch_norms(build())[0]) != base


@pytest.mark.parametrize("extra", [
    ["MODEL.LOCAL_MAP_SIZE", "0"], ["MODEL.LOCAL_MAP_SIZE", "3"],
    ["MODEL.WITH_PREVIOUS", "False"]], ids=["map0", "map3", "single"])
def test_stage_list_matches_jax(extra):
    """(e) The exact-growth schedule of the JAX bundle."""
    opts = OPTS + extra
    jmodel = jax_build_model(jax_get_cfg(opts=opts), dtype=None)
    model = build_model(get_cfg(opts=opts), device="cpu")
    assert stage_list(model) == jax_stage_list(jmodel)


def test_cpu_bundle_equals_streaming_step_and_round_trips(tmp_path):
    """(f) Five frames through the bundle on the CPU, bit-equal to
    streaming_step; the bundle file (JSON) round-trips, and another model
    is refused."""
    model = build_model(get_cfg(opts=OPTS), device="cpu", seed=3)
    frames = _frames(5, seed=43)
    K, bl, T = _geometry()
    ref = [d[0] for d in _stream(model, frames)]
    path = tmp_path / "bundle.json"
    meta = export_streaming_bundle(model, str(path), 1, H, W,
                                   progress=lambda s: None)
    assert meta["stages"] == ["g0", "g1", "g2", "g3", "steady"]
    assert meta["platform"] == "cpu" and meta["input_dtype"] == "float32"
    # the bundle built here runs twice (again after reset), the loaded one
    # once
    for bundle, runs in ((StreamingBundle(bundle_meta(model, 1, H, W), model),
                          2),
                         (load_streaming_bundle(str(path), model,
                                                progress=lambda s: None), 1)):
        stages = []
        for _ in range(runs):
            bundle.reset()
            for (left, right), want in zip(frames, ref):
                stages.append(bundle.stage_name())
                assert torch.equal(bundle.step(left, right, K, bl, T), want)
        assert stages == runs * ["g0", "g1", "g2", "g3", "steady"]
        with pytest.raises(ValueError, match="expected"):
            bundle.step(frames[0][0].double(), frames[0][1], K, bl, T)
    other = build_model(get_cfg(opts=OTHER_MAP), device="cpu")
    for wrong in (other, fold_batch_norms(model)[0]):
        with pytest.raises(ValueError, match="different model"):
            load_streaming_bundle(str(path), wrong)


def test_load_weights_reads_reference_checkpoints(jax_variables, tmp_path):
    """The JAX package's reference .ckpt, and a state_dict under "model" in
    a .pt, strict-load; another extension names the converter."""
    want = state_dict_from_jax(jax_variables["params"],
                               jax_variables["batch_stats"], TINY_GROUPS)
    ckpt = str(tmp_path / "ref.ckpt")
    save_reference_checkpoint(jax_variables, ckpt, TINY_GROUPS)
    torch.save({"model": want}, tmp_path / "ours.pt")
    for path in (ckpt, str(tmp_path / "ours.pt")):
        model = build_model(get_cfg(opts=OPTS), device="cpu", seed=5)
        assert load_weights(model, path) == len(want)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="export_reference"):
        load_weights(model, str(tmp_path / "weights.msgpack"))


def test_fold_refuses_train_mode():
    """(g) Folding is for eval only."""
    model = build_model(get_cfg(opts=OPTS), device="cpu").train()
    with pytest.raises(ValueError, match="eval-mode"):
        fold_batch_norms(model)


def test_capture_safe_constants_serve_autograd_later():
    """The hypothesis fractions are made once per device (a CUDA graph
    cannot capture their host-to-device copy); made first under the
    stream's inference mode, they still serve a training step."""
    low = torch.rand((1, 4, 5, 1), dtype=torch.float64)
    with torch.inference_mode():
        fractional_disparity_samples(low, low + 8)
    low.requires_grad_()
    fractional_disparity_samples(low, low + 8).sum().backward()
    assert torch.equal(low.grad, torch.full_like(low, 5.0))

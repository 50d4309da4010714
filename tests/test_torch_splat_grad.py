"""The splat's gradient (kernels/splat.py) against the JAX package on the CPU.

The port's ``softsplat`` is differentiable in inputs, flow and metric, in
all four modes, as the JAX package's ``ops/softsplat.py:softsplat`` is
(its Pallas splat's custom vjp is the einsum splat's autodiff,
``ops/pallas/splat.py:104``).  On the CPU the port differentiates its plain
version; ``softsplat_vjp_plain`` is the per-source formula that the card's
one backward launch (``csrc/softsplat_backward.cu``) computes, from the
normaliser the forward keeps, and ``summation_splat_vjp_plain`` its
summation mode's gather.  Inputs come from numpy at a seed; flows keep
every fractional part in [0.05, 0.95], where floor() (a constant to both)
cannot flip between the two frameworks' coordinate arithmetic.
Tolerances: 1e-4 against JAX (its einsum sums the splat over one-hot
matrices), 1e-6 of the largest value between the port's own two
formulations of the same sums.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from temporalstereo_tpu.ops.softsplat import softsplat as jax_softsplat

from temporalstereo_tpu_torch.config import get_cfg
from temporalstereo_tpu_torch.kernels import (softsplat, softsplat_plain,
                                              softsplat_vjp,
                                              softsplat_vjp_plain,
                                              summation_splat_vjp_plain)
from temporalstereo_tpu_torch.kernels.splat import (_summation_plain,
                                                    _weighted)
from temporalstereo_tpu_torch.models import build_model

MODES = ("summation", "average", "linear", "softmax")
JAX_TOL = 1e-4
PORT_TOL = 1e-6
SHAPE = (2, 5, 7, 3)


def _off_integer(flow):
    """Every fractional part moved into [0.05, 0.95]."""
    whole = np.floor(flow)
    return (whole + 0.05 + 0.9 * (flow - whole)).astype(np.float32)


def _case(mode, seed=5, flow_span=None):
    """(inputs, flow, metric or None, output gradient), numpy f32.  Flows
    span +-3 px in summation mode and +-1 px in the normalised ones (see
    ``test_softsplat_gradients_match_jax``) unless ``flow_span`` says."""
    if flow_span is None:
        flow_span = 3.0 if mode == "summation" else 1.0
    rng = np.random.RandomState(seed)
    b, h, w, c = SHAPE
    inputs = rng.randn(b, h, w, c).astype(np.float32)
    flow = _off_integer(rng.uniform(-flow_span, flow_span, (b, h, w, 2)))
    metric = None
    if mode == "softmax":
        metric = rng.randn(b, h, w, 1).astype(np.float32)
    elif mode == "linear":
        metric = (rng.rand(b, h, w, 1) + 0.5).astype(np.float32)
    g = rng.randn(b, h, w, c).astype(np.float32)
    return inputs, flow, metric, g


def _jax_grads(mode, method, inputs, flow, metric, g):
    args = [jnp.asarray(inputs), jnp.asarray(flow)]
    if metric is not None:
        args.append(jnp.asarray(metric))

    def f(*a):
        return jax_softsplat(a[0], a[1], a[2] if len(a) == 3 else None,
                             mode=mode, method=method)
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(mode, inputs, flow, metric, g):
    leaves = [torch.from_numpy(x).requires_grad_()
              for x in (inputs, flow, metric) if x is not None]
    out = softsplat(*leaves[:2], leaves[2] if len(leaves) == 3 else None,
                    mode)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [x.numpy() for x in grads], out.detach()


def _assert_close(ours, theirs, tol, what):
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"{what}: gradient {i}")


@pytest.mark.parametrize("method", ("pallas", "einsum"))
@pytest.mark.parametrize("mode", MODES)
def test_softsplat_gradients_match_jax(mode, method):
    """Autograd of the port's softsplat, and the card's backward formula
    (``softsplat_vjp_plain``, its normaliser splatted again or kept by the
    forward: the same bits), against ``jax.vjp`` of the JAX softsplat: the
    Pallas splat in interpret mode (as tests/test_pallas.py runs it) and
    the einsum splat.  In the normalised modes JAX's vjp is NaN for every
    source as soon as one target cell gets no weight (its derivative of
    x / (n + eps) squares n + eps = 1e-22, which is 0 in f32, and the
    one-hot einsum carries 0 * NaN to every source), so these flows stay
    within +-1 px, where every cell gets a tap of every source at it;
    ``test_softsplat_gradients_finite_where_cells_are_empty`` holds the
    port there."""
    inputs, flow, metric, g = _case(mode)
    if method == "pallas":
        with pltpu.force_tpu_interpret_mode():
            theirs = _jax_grads(mode, method, inputs, flow, metric, g)
    else:
        theirs = _jax_grads(mode, method, inputs, flow, metric, g)
    ours, out = _port_grads(mode, inputs, flow, metric, g)
    assert len(ours) == len(theirs) == (2 if metric is None else 3)
    assert np.abs(theirs[1]).max() > 0          # the flow has a gradient
    _assert_close(ours, theirs, JAX_TOL, f"autograd {mode}")
    args = _torch_args(inputs, flow, metric)
    chain = softsplat_vjp(*args, out, torch.from_numpy(g), mode)
    assert (chain[2] is None) == (metric is None)
    _assert_close([x.numpy() for x in chain if x is not None], theirs,
                  JAX_TOL, f"softsplat_vjp {mode}")
    out_k, norm = softsplat_plain(*args, mode, keep_norm=True)
    kept = softsplat_vjp_plain(*args, out_k, torch.from_numpy(g), mode,
                               norm=norm)
    for a, b in zip(kept, chain):
        assert (a is None and b is None) or torch.equal(a, b)


def _torch_args(inputs, flow, metric):
    return (torch.from_numpy(inputs), torch.from_numpy(flow),
            None if metric is None else torch.from_numpy(metric))


@pytest.mark.parametrize("mode", MODES[1:])
def test_softsplat_gradients_finite_where_cells_are_empty(mode):
    """Flows of +-3 px leave target cells without weight: the port's
    gradients stay finite there (it divides by n + eps once, not by its
    square) and its two formulations agree with the plain version's
    autograd in f64."""
    inputs, flow, metric, g = _case(mode, flow_span=3.0)
    ours, out = _port_grads(mode, inputs, flow, metric, g)
    leaves = [torch.from_numpy(x).double().requires_grad_()
              for x in (inputs, flow, metric) if x is not None]
    s = _summation_plain(_weighted(leaves[0], leaves[2] if len(leaves) == 3
                                   else None, mode), leaves[1])
    assert (s[..., -1] == 0).any()              # some cells are empty
    ref = torch.autograd.grad(s[..., :-1] / (s[..., -1:] + 1e-22), leaves,
                              torch.from_numpy(g).double())
    chain = softsplat_vjp(*_torch_args(inputs, flow, metric), out,
                          torch.from_numpy(g), mode)
    for got in (ours, [x.numpy() for x in chain if x is not None]):
        for a, r in zip(got, ref):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, r.numpy(), rtol=JAX_TOL,
                                       atol=JAX_TOL * float(r.abs().max()))


def _vjp_case(case, seed=9):
    """(values, flow, g) torch f32: a strided values view and a strided
    flow, as update_prev_info slices its flow out of project_to_3d's."""
    rng = np.random.RandomState(seed)
    b, h, w, c = SHAPE
    values = torch.from_numpy(rng.randn(b, h, w, c + 2).astype(np.float32)
                              )[..., 1:1 + c]
    if case == "spread":
        flow = _off_integer(rng.uniform(-3, 3, (b, h, w, 2)))
    else:                                       # every source onto one point
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        flow = np.stack([w // 2 + 0.25 - xs, h // 2 + 0.5 - ys], -1)
        flow = np.broadcast_to(flow, (b, h, w, 2)).astype(np.float32)
    wide = np.zeros((b, h, w, 3, 2), np.float32)
    wide[:, :, :, 1] = flow
    flow = torch.from_numpy(wide)[:, :, :, 1, :]
    g = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    return values, flow, g


@pytest.mark.parametrize("case", ("spread", "one_point"))
def test_summation_vjp_plain_matches_autograd(case):
    """The gather formula the kernel computes in summation mode against
    autograd of the plain scatter, on strided inputs, sources spread and
    all on one point; the CPU wrapper runs the same plain gather."""
    values, flow, g = _vjp_case(case)
    assert not values.is_contiguous() and not flow.is_contiguous()
    leaves = [values.detach().requires_grad_(),
              flow.detach().requires_grad_()]
    out = softsplat_plain(*leaves, None, "summation")
    want = torch.autograd.grad(out, leaves, g)
    got = summation_splat_vjp_plain(values, flow, g)
    wrapped = softsplat_vjp(values, flow, None, None, g, "summation")
    for a, b, c in zip(got, want, wrapped):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=PORT_TOL * float(b.abs().max()))
        assert torch.equal(a, c)


def _division_chain(inputs, flow, metric, out, g, mode, eps=1e-22):
    """The splat's vjp as a chain of whole-tensor steps: the normaliser
    splatted again, the output's gradient divided by it (n + eps) at the
    targets, the summation splat's gather over all C + 1 channels, then the
    chain to inputs and metric."""
    vals = _weighted(inputs, metric, mode)
    if mode == "summation":
        return (*summation_splat_vjp_plain(vals, flow, g), None)
    weight = vals[..., -1:]
    denom = _summation_plain(weight, flow) + eps
    g_s = torch.cat([g / denom, -(g * out).sum(-1, keepdim=True) / denom],
                    dim=-1)
    g_vals, g_flow = summation_splat_vjp_plain(vals, flow, g_s)
    g_in, g_w = g_vals[..., :-1], g_vals[..., -1:]
    if mode == "average":
        return g_in, g_flow, None
    g_metric = (g_in * inputs).sum(-1, keepdim=True) + g_w
    if mode == "softmax":
        g_metric = g_metric * weight
    return g_in * weight, g_flow, g_metric


@pytest.mark.parametrize("flow_span", (1.0, 3.0))
@pytest.mark.parametrize("mode", MODES)
def test_softsplat_vjp_plain_matches_the_division_chain(mode, flow_span):
    """The per-source formula (reciprocal of the kept normaliser) against
    the chain that divides by a normaliser splatted again, within 1e-6 of
    the largest value; and the forward's kept normaliser bit-equal to the
    weight channel's own splat."""
    inputs, flow, metric, g = _case(mode, seed=7, flow_span=flow_span)
    args = _torch_args(inputs, flow, metric)
    out, norm = softsplat_plain(*args, mode, keep_norm=True)
    assert torch.equal(out, softsplat_plain(*args, mode))
    if mode != "summation":
        weight = _weighted(args[0], args[2], mode)[..., -1:]
        assert torch.equal(norm, _summation_plain(weight, args[1]))
    else:
        assert norm is None
    got = softsplat_vjp_plain(*args, out, torch.from_numpy(g), mode,
                              norm=norm)
    want = _division_chain(*args, out, torch.from_numpy(g), mode)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=PORT_TOL * float(b.abs().max()))


def test_update_prev_info_stops_the_gradient():
    """In a train-mode forward with gradients on, the temporal state the
    splat warps carries no graph (JAX stops the gradient there,
    ``models/stereo.py:239``), even where the carried disparity it warps
    by has one."""
    opts = ["MODEL.BACKBONE.VARIANT", "tiny",
            "MODEL.AGGREGATION.COARSE.C", "8",
            "MODEL.AGGREGATION.FINE.C", "8",
            "MODEL.AGGREGATION.PRECISE.C", "8",
            "TRAINER.PRECISION", "f32",
            "MODEL.WITH_PREVIOUS", "True",
            "MODEL.USE_PAST_COST", "True",
            "MODEL.LOCAL_MAP_SIZE", "3"]
    from temporalstereo_tpu_torch.models import (backbone_memory_shapes,
                                                 init_prev_info,
                                                 update_prev_info)

    model = build_model(get_cfg(opts=opts), device="cpu", seed=0)
    model.train()
    h, w = 64, 96
    rng = np.random.RandomState(3)
    left, right = (torch.from_numpy(rng.rand(1, h, w, 3).astype(np.float32))
                   for _ in range(2))
    prev = init_prev_info(model, 1, (h, w),
                          backbone_memory_shapes(model.backbone_cfg, (h, w)),
                          2, local_map_channels=0)
    out, prev = model(left, right, prev)
    assert out["disps"][0].grad_fn is not None
    # the carried disparity as a BPTT caller could hand it over: with a
    # gradient, which reaches the splat's flow, metric and inputs
    prev = dataclasses.replace(prev, prev_disp=out["disps"][0].float())
    K = torch.tensor([[[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]]])
    T = torch.eye(4)[None].clone()
    T[0, 0, 3] = 0.1
    warped = update_prev_info(prev, K, torch.ones(1), T, (h, w), True, 3)
    for name in ("disp_sample", "cost_volume"):
        assert getattr(warped.cost_memory, name).grad_fn is None, name
    assert warped.local_map.grad_fn is None

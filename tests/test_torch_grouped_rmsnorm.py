"""K5 / K5b, the packed model's ``GroupedRMSNorm`` (``ops/
grouped_rmsnorm_kernel.py``) and K5's consumer epilogues, on the CPU.

The CUDA kernels (``csrc/grouped_rmsnorm.cu``, ``csrc/
grouped_rmsnorm_bwd.cu``) run only on the card, where ``chip_smoke.py``
holds them to their plain versions.  Here: the plain forward against the
JAX module (``tera_mind_tpu/models/unet_packed.py``) for 1-3 segments with
an odd one, Z of 1, 2, 4 and 8, both weight layouts, float32 and bf16 and
a float32 weight of a bf16 x; the autograd Function's gradient against
``jax.grad`` of that module; the dispatcher's routing and the raw
launcher's autograd guard; the variant rule on every shape the paths give
K5; and Python mirrors of the kernels' layouts (the vector variant's lane
plan, the staged variant's plane groups, the dw reduction's fold) held to
the constants in the ``.cu`` sources.  The epilogues (``silu``, the adaLN
``modulate_silu``): the plain sequence against JAX's module, modulate and
``nn.silu``; the dispatcher's split path under autograd, with today's
gradients; the refusals; the launches a UNet call takes by epilogue.
"""

import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tera_mind_tpu.models import unet_packed as jpk
from tera_mind_tpu_torch.models import unet_packed as tpk
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
from tera_mind_tpu_torch.ops.rmsnorm_kernel import vector_group


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: several test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEGMENTS = [(12,), (16, 8, 7), (5, 3), (8, 16)]
ZS = [1, 2, 4, 8]
CASES = [(segs, z, from_5d) for segs in SEGMENTS for z in ZS
         for from_5d in (False, True)]


def inputs(segs, z, from_5d, seed):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((2, 3, 5, z * sum(segs)))).astype(
        np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(
        k5.weight_len(z, segs, from_5d))).astype(np.float32)
    return x, w


def jax_module(segs, z, from_5d):
    return jpk.GroupedRMSNorm(z=z, segments=segs, from_5d=from_5d)


def spacing(a):
    """The bf16 spacing at |a|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
                   - 7)


# ------------------------------------------------------------------ #
# the plain forward against the JAX module                            #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("segs,z,from_5d", CASES)
def test_plain_forward_matches_jax_f32(segs, z, from_5d):
    x, w = inputs(segs, z, from_5d, seed=z + len(segs))
    want = np.asarray(jax_module(segs, z, from_5d).apply(
        {"params": {"weight": w}}, jnp.asarray(x)))
    got = k5.grouped_rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(w),
                                   z, segs, from_5d=from_5d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("segs,z,from_5d", CASES)
@pytest.mark.parametrize("w_dtype", ["bfloat16", "float32"])
def test_plain_forward_matches_jax_bf16(segs, z, from_5d, w_dtype):
    """Both round inv to bf16 and then after each of the two multiplies;
    the float32 statistics are summed in other orders, so at most 1 bf16
    spacing apart.  A float32 weight of a bf16 x (training's master
    weight) is rounded to bf16 first by both."""
    x, w = inputs(segs, z, from_5d, seed=10 + z + len(segs))
    xb = x.astype(ml_dtypes.bfloat16)
    wj = w.astype(ml_dtypes.bfloat16) if w_dtype == "bfloat16" else w
    want = np.asarray(jax_module(segs, z, from_5d).apply(
        {"params": {"weight": wj}}, jnp.asarray(xb))).astype(np.float32)
    wt = torch.from_numpy(w)
    got = k5.grouped_rmsnorm_plain(
        torch.from_numpy(x).bfloat16(),
        wt.bfloat16() if w_dtype == "bfloat16" else wt, z, segs,
        from_5d=from_5d)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= spacing(want)).all()


def test_module_runs_the_dispatcher():
    """``GroupedRMSNorm`` is the dispatcher on its weight and layout: the
    plain version on a CPU tensor, the Function under autograd."""
    m = tpk.GroupedRMSNorm(2, (16, 8, 7), from_5d=True)
    with torch.no_grad():
        m.weight.copy_(1 + 0.1 * torch.arange(31.0) / 31)
    x = torch.from_numpy(inputs((16, 8, 7), 2, True, 3)[0])
    with torch.no_grad():
        y = m(x)
    assert torch.equal(y, k5.grouped_rmsnorm_plain(
        x, m.weight, 2, (16, 8, 7), from_5d=True))
    assert type(m(x).grad_fn).__name__ == "GroupedRMSNormFunctionBackward"


# ------------------------------------------------------------------ #
# the backward against jax.grad of the module                         #
# ------------------------------------------------------------------ #
def jax_grads(segs, z, from_5d, x, w):
    """(dx, dw) of the summed output of JAX's module (float32 sum)."""
    m = jax_module(segs, z, from_5d)

    def loss(p, xx):
        return m.apply(p, xx).astype(jnp.float32).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))({"params": {"weight": w}},
                                            jnp.asarray(x))
    return (np.asarray(gx).astype(np.float32),
            np.asarray(gp["params"]["weight"]).astype(np.float32))


def torch_grads(x, w, z, segs, from_5d):
    xt = x.detach().requires_grad_()
    wt = torch.nn.Parameter(w)
    y = k5.grouped_rmsnorm_act(xt, wt, z, segs, from_5d=from_5d)
    assert type(y.grad_fn).__name__ == "GroupedRMSNormFunctionBackward"
    y.float().sum().backward()
    return xt.grad, wt.grad


def rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("segs,z,from_5d", CASES)
def test_function_gradient_matches_jax_grad_f32(segs, z, from_5d):
    x, w = inputs(segs, z, from_5d, seed=20 + z + len(segs))
    want_dx, want_dw = jax_grads(segs, z, from_5d, x, w)
    dx, dw = torch_grads(torch.from_numpy(x), torch.from_numpy(w), z, segs,
                         from_5d)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    assert dw.shape == (k5.weight_len(z, segs, from_5d),)
    assert rel(dx.numpy(), want_dx) <= 1e-5
    assert rel(dw.numpy(), want_dw) <= 1e-5


# JAX's autodiff of the bf16 module rounds each step of its backward to
# bf16 (x * sc and its cotangent, the masked sum that carries dsc, the
# rsqrt's derivative, each plane's share); K5b computes the formula in
# float32 and rounds dx once.  So K5b's bf16 dx lies within 1 spacing of
# the float64 gradient of the same bf16 inputs, while JAX's strays by up
# to a few % of max |dx|, and the two are held to each other at that
# level: within BF16_DX_REL of max |dx|.  dw is a float32 sum on both
# sides (JAX casts the bf16 cotangent of w.astype(bf16) to the float32
# parameter), BF16_DW_REL of max |dw|.
BF16_DX_REL = 0.05
BF16_DW_REL = 0.02


@pytest.mark.parametrize("segs,z,from_5d", CASES)
def test_function_gradient_matches_jax_grad_bf16(segs, z, from_5d):
    x, w = inputs(segs, z, from_5d, seed=30 + z + len(segs))
    xb = x.astype(ml_dtypes.bfloat16)
    want_dx, want_dw = jax_grads(segs, z, from_5d, xb, w)
    xt = torch.from_numpy(xb.astype(np.float32)).bfloat16()
    dx, dw = torch_grads(xt, torch.from_numpy(w), z, segs, from_5d)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    # K5b's formula in float64 on the same bf16 inputs and float32 weight:
    # within one bf16 rounding, and a float32 ulp of the formula's terms
    # where they cancel
    exact = k5.grouped_rmsnorm_bwd_plain(
        xt.double(), torch.ones_like(xt, dtype=torch.float64),
        torch.from_numpy(w).double(), z, segs, from_5d=from_5d)[0].numpy()
    assert (np.abs(dx.double().numpy() - exact)
            <= spacing(exact) + 1e-6 * np.abs(exact).max()).all()
    assert rel(dx.float().numpy(), want_dx) <= BF16_DX_REL
    assert rel(dw.numpy(), want_dw) <= BF16_DW_REL


@pytest.mark.parametrize("segs,z,from_5d", [((16, 8, 7), 2, True),
                                            ((5, 3), 4, False),
                                            ((6,), 1, True)])
def test_function_gradient_is_the_plain_gradient(segs, z, from_5d):
    """On the CPU the Function (the plain forward and the plain backward
    formula) passes gradcheck in float64 and equals autograd through
    ``grouped_rmsnorm_plain``."""
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.standard_normal(
        (3, 2, z * sum(segs)))).requires_grad_()
    w = torch.from_numpy(1 + 0.2 * rng.standard_normal(
        k5.weight_len(z, segs, from_5d))).requires_grad_()

    def f(a, b):
        return k5.grouped_rmsnorm_act(a, b, z, segs, from_5d=from_5d)

    assert torch.autograd.gradcheck(f, (x, w))
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape)))
    got = torch.autograd.grad(f(x, w), (x, w), g)
    want = torch.autograd.grad(k5.grouped_rmsnorm_plain(
        x, w, z, segs, from_5d=from_5d), (x, w), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


# ------------------------------------------------------------------ #
# the epilogues: the plain sequence against JAX                       #
# ------------------------------------------------------------------ #
ACT_CASES = [((16, 8, 7), 2, False, "silu"), ((16, 8, 7), 2, True, "silu"),
             ((5, 3), 4, False, "silu"), ((12,), 2, False, "modulate_silu"),
             ((12,), 2, True, "modulate_silu"), ((7,), 4, True,
                                                 "modulate_silu")]


def act_inputs(segs, z, from_5d, act, seed):
    """x (2, 3, 5, Z*Ctot), the weight and, for the modulate, (2, C)
    scale and shift: two batches, so each batch's rows read their own."""
    x, w = inputs(segs, z, from_5d, seed)
    rng = np.random.default_rng(seed + 100)
    if act != "modulate_silu":
        return x, w, None, None
    sc, sh = (0.5 * rng.standard_normal((2, 2, segs[0]))).astype(np.float32)
    return x, w, sc, sh


def jax_act(segs, z, from_5d, act, x, w, sc, sh):
    """JAX's GroupedRMSNorm, then the ResBlock's modulate (scale and shift
    tiled over the planes, unet_packed.py:282-287) and ``nn.silu``; also
    the norm's output."""
    import flax.linen as fnn
    y = jax_module(segs, z, from_5d).apply({"params": {"weight": w}},
                                           jnp.asarray(x))
    h = y
    if act == "modulate_silu":
        scale = jnp.tile(jnp.asarray(sc), (1, z))[:, None, None, :]
        shift = jnp.tile(jnp.asarray(sh), (1, z))[:, None, None, :]
        h = h * (1.0 + scale) + shift
    return np.asarray(fnn.silu(h)), np.asarray(y)


def torch_act(x, w, z, segs, from_5d, act, sc, sh, dtype):
    mod = ({} if sc is None else
           dict(scale=torch.from_numpy(sc).to(dtype),
                shift=torch.from_numpy(sh).to(dtype)))
    return k5.grouped_rmsnorm_act_plain(
        torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype), z,
        segs, from_5d=from_5d, act=act, **mod)


@pytest.mark.parametrize("segs,z,from_5d,act", ACT_CASES)
def test_act_plain_matches_jax_f32(segs, z, from_5d, act):
    x, w, sc, sh = act_inputs(segs, z, from_5d, act, seed=20 + z)
    want, _ = jax_act(segs, z, from_5d, act, x, w, sc, sh)
    got = torch_act(x, w, z, segs, from_5d, act, sc, sh, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("segs,z,from_5d,act", ACT_CASES)
def test_act_plain_matches_jax_bf16(segs, z, from_5d, act):
    """Both round to bf16 after the norm's two multiplies (1 spacing
    apart, see above), after 1 + scale, the product and the sum, and
    after the SiLU (JAX may fuse the modulate and round once).  The sum
    can cancel, so the gate is 3 spacings at the magnitude of the
    modulate's terms (|y (1 + scale)|, |shift|) or of the output."""
    x, w, sc, sh = act_inputs(segs, z, from_5d, act, seed=30 + z)
    b16 = ml_dtypes.bfloat16
    xb, wb = x.astype(b16), w.astype(b16)
    scb = None if sc is None else sc.astype(b16)
    shb = None if sh is None else sh.astype(b16)
    want, y = jax_act(segs, z, from_5d, act, xb, wb, scb, shb)
    want, y = want.astype(np.float32), y.astype(np.float32)
    got = torch_act(xb.astype(np.float32), wb.astype(np.float32), z, segs,
                    from_5d, act, None if sc is None else
                    scb.astype(np.float32), None if sh is None else
                    shb.astype(np.float32), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    mag = np.abs(want)
    if act == "modulate_silu":
        m = 1.0 + np.tile(scb.astype(np.float32), (1, z))[:, None, None, :]
        s = np.tile(shb.astype(np.float32), (1, z))[:, None, None, :]
        mag = np.maximum(mag, np.maximum(np.abs(y * m), np.abs(s)))
    else:
        mag = np.maximum(mag, np.abs(y))
    assert (np.abs(got.float().numpy() - want) <= 3 * spacing(mag)).all()


def test_act_plain_is_the_eager_sequence():
    """``grouped_rmsnorm_act_plain`` is exactly the ResBlock's former
    eager sequence: the norm, ``h * (1.0 + scale) + shift`` with the
    (B, C) halves repeated over the planes, then ``F.silu``; bit-equal in
    bf16 and float32, with rows per batch the map's H x W."""
    import torch.nn.functional as F
    for dtype in (torch.float32, torch.bfloat16):
        x, w, sc, sh = act_inputs((12,), 2, False, "modulate_silu", 3)
        xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w)
        st, ht = torch.from_numpy(sc).to(dtype), torch.from_numpy(sh).to(dtype)
        y = k5.grouped_rmsnorm_plain(xt, wt, 2, (12,))
        want = F.silu(y * (1.0 + st.repeat(1, 2)[:, None, None, :])
                      + ht.repeat(1, 2)[:, None, None, :])
        got = k5.grouped_rmsnorm_act_plain(xt, wt, 2, (12,),
                                           act="modulate_silu", scale=st,
                                           shift=ht)
        assert torch.equal(got, want)
        assert torch.equal(k5.grouped_rmsnorm_act_plain(
            xt, wt, 2, (12,), act="silu"), F.silu(y))
        # one batch: every row reads row 0 of scale and shift
        one = k5.grouped_rmsnorm_act_plain(xt, wt, 2, (12,),
                                           act="modulate_silu",
                                           scale=st[:1], shift=ht[:1])
        assert torch.equal(one[0], got[0])
        assert k5.check_epilogue("modulate_silu", (12,), xt, st, ht) == 15
        assert k5.check_epilogue("modulate_silu", (12,), xt, st[:1],
                                 ht[:1]) == 30


def test_modulate_refused_where_it_cannot_run():
    """The modulate takes one segment and (B, C) scale and shift, B x's
    batch or 1; other epilogues take neither; an unknown epilogue is
    refused: by the dispatcher, the plain version and the CUDA launcher
    alike, before any launch."""
    x, w, sc, sh = act_inputs((8, 16), 2, False, "silu", 4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    s2 = torch.zeros(2, 8)
    calls = (k5.grouped_rmsnorm_act, k5.grouped_rmsnorm_act_plain,
             k5.grouped_rmsnorm_cuda)
    for fn in calls:
        with pytest.raises(ValueError, match="one segment"):
            fn(xt, wt, 2, (8, 16), act="modulate_silu", scale=s2, shift=s2)
        with pytest.raises(ValueError, match="takes no scale"):
            fn(xt, wt, 2, (8, 16), act="silu", scale=s2, shift=s2)
        with pytest.raises(ValueError, match="none of"):
            fn(xt, wt, 2, (8, 16), act="gelu")
    x1, w1 = torch.zeros(2, 3, 5, 24), torch.ones(24)
    for scale, shift in ((torch.zeros(3, 12), torch.zeros(3, 12)),
                         (torch.zeros(2, 11), torch.zeros(2, 11)),
                         (torch.zeros(2, 12), None),
                         (torch.zeros(2, 12), torch.zeros(1, 12))):
        for fn in calls:
            with pytest.raises(ValueError):
                fn(x1, w1, 2, (12,), act="modulate_silu", scale=scale,
                   shift=shift)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "silu", "modulate_silu"])
@pytest.mark.parametrize("from_5d", [False, True])
def test_bias_prologue_is_the_plain_sequence_on_the_biased_x(dtype, act,
                                                             from_5d):
    """K5's prologue (in_conv's bias, added before the out_norm) in the
    plain version: bit-equal to the plain sequence run on ``r(x + b)``,
    the conv's eager bias add rounded to x's dtype, with each epilogue;
    the dispatcher takes it on the CPU, no launch."""
    x, w, sc, sh = act_inputs((12,), 2, from_5d, act, 6)
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(w).to(dtype)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(24)
                         .astype(np.float32)).to(dtype)
    mod = ({} if sc is None else dict(scale=torch.from_numpy(sc).to(dtype),
                                      shift=torch.from_numpy(sh).to(dtype)))
    biased = xt.clone()
    biased.permute(0, 3, 1, 2).add_(b.reshape(1, -1, 1, 1))   # eager add_
    want = k5.grouped_rmsnorm_act_plain(biased, wt, 2, (12,),
                                        from_5d=from_5d, act=act, **mod)
    got = k5.grouped_rmsnorm_act_plain(xt, wt, 2, (12,), from_5d=from_5d,
                                       act=act, bias=b, **mod)
    assert got.dtype == dtype and torch.equal(got, want)
    k5.reset_launches()
    with torch.no_grad():
        assert torch.equal(k5.grouped_rmsnorm_act(
            xt, wt, 2, (12,), from_5d=from_5d, act=act, bias=b, **mod), want)
    assert k5.launches == 0
    # the module passes it through
    norm = tpk.GroupedRMSNorm(2, (12,), from_5d=from_5d).to(dtype)
    with torch.no_grad():
        norm.weight.copy_(wt)
        assert torch.equal(norm(xt, act, bias=b, **mod), want)


def test_bias_prologue_refused_where_it_cannot_run():
    """A prologue's bias takes one segment (a conv's output feeds one
    out_norm) and is (Z*C,) of x's dtype: anything else is refused by the
    dispatcher, the plain version and the CUDA launcher alike, before any
    launch."""
    x, w = inputs((8, 16), 2, False, 4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    calls = (k5.grouped_rmsnorm_act, k5.grouped_rmsnorm_act_plain,
             k5.grouped_rmsnorm_cuda)
    k5.reset_launches()
    for fn in calls:
        with pytest.raises(ValueError, match="one segment"):
            fn(xt, wt, 2, (8, 16), bias=torch.zeros(48))
    x1, w1 = torch.zeros(2, 3, 5, 24), torch.ones(24)
    for bias in (torch.zeros(12), torch.zeros(1, 24),
                 torch.zeros(24, dtype=torch.bfloat16)):
        for fn in calls:
            with pytest.raises(ValueError, match="bias"):
                fn(x1, w1, 2, (12,), act="silu", bias=bias)
    assert k5.launches == 0 and k5.launches_by_prologue == {"none": 0,
                                                            "bias": 0}


def test_bias_prologue_under_autograd_is_the_eager_add():
    """Where autograd records, the dispatcher adds the bias eagerly and
    runs the norm's Function: the output and every gradient (x, the
    weight, the bias, scale and shift) equal the eager add followed by
    the dispatcher without a bias."""
    x, w, sc, sh = act_inputs((12,), 2, False, "modulate_silu", 8)

    def run(with_bias):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        b = torch.linspace(-1, 1, 24).requires_grad_(True)
        st = torch.from_numpy(sc).requires_grad_(True)
        ht = torch.from_numpy(sh).requires_grad_(True)
        if with_bias:
            out = k5.grouped_rmsnorm_act(xt, wt, 2, (12,),
                                         act="modulate_silu", scale=st,
                                         shift=ht, bias=b)
        else:
            out = k5.grouped_rmsnorm_act(xt + b, wt, 2, (12,),
                                         act="modulate_silu", scale=st,
                                         shift=ht)
        (out * torch.linspace(-1, 1, 24)).sum().backward()
        return out, [t.grad for t in (xt, wt, b, st, ht)]

    out, grads = run(True)
    want, want_grads = run(False)
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_counters_count_prologues():
    """K5's launches by prologue reset with its other counters."""
    k5.reset_launches()
    _build.count_launch(k5, "vector", "modulate_silu", "bias")
    _build.count_launch(k5, "vector", "silu", "none")
    assert k5.launches_by_prologue == {"none": 1, "bias": 1}
    k5.reset_launches()
    assert set(k5.launches_by_prologue.values()) == {0}


@pytest.mark.parametrize("act", ["silu", "modulate_silu"])
def test_dispatcher_splits_the_epilogue_under_autograd(act):
    """Where autograd records, the dispatcher runs the norm's Function (K5
    and K5b on the card) and then the eager epilogue: the same ops as the
    ResBlock ran before, so the output and every gradient (x, the
    weight, scale, shift) are bit-equal to that sequence's; with no
    gradient to record a CPU tensor takes the plain sequence.  No K5
    launch is counted on the CPU."""
    import torch.nn.functional as F
    segs = (12,) if act == "modulate_silu" else (8, 16)
    x, w, sc, sh = act_inputs(segs, 2, True, act, 6)
    before = (k5.launches, k5.bwd.launches)

    def run(fused):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.nn.Parameter(torch.from_numpy(w))
        st = None if sc is None else torch.from_numpy(sc).requires_grad_()
        ht = None if sh is None else torch.from_numpy(sh).requires_grad_()
        if fused:
            out = k5.grouped_rmsnorm_act(xt, wt, 2, segs, from_5d=True,
                                         act=act, scale=st, shift=ht)
        else:
            out = k5.grouped_rmsnorm_act(xt, wt, 2, segs, from_5d=True)
            if st is not None:
                out = (out * (1.0 + st.repeat(1, 2)[:, None, None, :])
                       + ht.repeat(1, 2)[:, None, None, :])
            out = F.silu(out)
        (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
        leaves = [xt, wt] + [t for t in (st, ht) if t is not None]
        return out, [leaf.grad for leaf in leaves]

    out, grads = run(True)
    want, want_grads = run(False)
    assert type(out.grad_fn).__name__ == "SiluBackward0"
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    mod = ({} if sc is None else dict(scale=torch.from_numpy(sc),
                                       shift=torch.from_numpy(sh)))
    with torch.no_grad():
        plain = k5.grouped_rmsnorm_act(torch.from_numpy(x),
                                       torch.from_numpy(w), 2, segs,
                                       from_5d=True, act=act, **mod)
    assert plain.grad_fn is None and torch.equal(plain, want.detach())
    assert (k5.launches, k5.bwd.launches) == before


def test_counters_count_epilogues():
    """K5's launches by epilogue reset with its other counters."""
    k5.reset_launches()
    _build.count_launch(k5, "vector", "silu")
    _build.count_launch(k5, "staged", "modulate_silu")
    assert k5.launches == 2
    assert k5.launches_by_epilogue == {"none": 0, "silu": 1,
                                       "modulate_silu": 1}
    k5.reset_launches()
    assert set(k5.launches_by_epilogue.values()) == {0}


def test_unet_call_takes_each_epilogue_where_the_model_asks():
    """A 638850 UNet call (scripts/kernel_shapes.py's stand-in on the meta
    device) launches K5 57 times: 29 with the SiLU (28 ResBlocks' in_norm
    and the UNet's out_norm) and 28 with the modulate (each ResBlock's
    out_norm), which removes 236.9 GB of eager passes a block-major step;
    a training microbatch's 88 launches take no epilogue (autograd
    records the eager one); chip_smoke.py's count from the model's
    modules is the same.  Each ResBlock's out_norm (the 28 modulates) adds
    in_conv's bias as its prologue and each ResBlock ends in one K6
    launch, which with the prologue removes 131.07 GB of eager passes a
    step; training takes neither."""
    import chip_smoke as cs
    ks = _kernel_shapes()
    k5s, acts, k6s = ks.Counter(), ks.Counter(), ks.Counter()
    ks.per_call_shapes(k5=k5s, k5_act=acts, k6=k6s)
    assert ks.by_epilogue(acts) == {"none": 0, "silu": 29,
                                    "modulate_silu": 28}
    assert ks.by_prologue(acts) == {"none": 29, "bias": 28}
    assert {k[5] for k in acts if k[3] == "modulate_silu"} == {"bias"}
    assert sum(k6s.values()) == 28
    assert sum(n for (_, _, skip), n in k6s.items() if skip == "conv") == 19
    fold = ks.fold_bytes(acts, k6s, 25)
    assert abs((sum(fold.values()) - 2 * fold["K6"]) / 1e9 - 131.07) < 0.01
    assert {k[3] for k in acts if len(k[1]) > 1} == {"silu"}
    # the modulate's batches: a z-window's 81 patches, the collage
    # decoder's 64; rows whole batches of H x W
    assert {k[4] for k in acts if k[3] == "modulate_silu"} == {81, 64}
    assert all(k[0] % k[4] == 0 for k in acts if k[3] == "modulate_silu")
    assert {k[4] for k in acts if k[3] != "modulate_silu"} == {0}
    removed = ks.eager_epilogue_bytes(acts, 25)
    assert abs(sum(removed.values()) / 1e9 - 236.91) < 0.01
    # the modulate's product, sum and SiLU each read and write the map
    assert removed["modulate_silu"] == 25 * sum(
        n * 3 * 2 * 2 * r * z * sum(s)
        for (r, s, z, a, _, _), n in acts.items() if a == "modulate_silu")
    train, train_k6 = ks.Counter(), ks.Counter()
    ks.train_shapes(True, k5_act=train, k6=train_k6)
    assert ks.by_epilogue(train) == {"none": 88, "silu": 0,
                                     "modulate_silu": 0}
    assert ks.by_prologue(train) == {"none": 88, "bias": 0}
    assert not train_k6
    with torch.device("meta"):
        model = tpk.make_packed_model(ks.preset_conf().make_model_conf())
    counts = cs.per_call_counts(model)
    assert counts[4] == ks.by_epilogue(acts)
    assert counts[5] == ks.by_prologue(acts)
    assert counts[6] == ks.by_variant("K6", k6s) == {"scalar": 0,
                                                     "vector": 28}
    pred = ks.chain_prediction(ks.preset_conf(), steps=1)
    assert pred["grouped_rmsnorm"]["by_epilogue"] == {
        "none": 0, "silu": 29 * 25, "modulate_silu": 28 * 25}
    assert pred["grouped_rmsnorm"]["by_prologue"] == {
        "none": 29 * 25, "bias": 28 * 25}
    assert pred["residual"]["launches"] == 28 * 25
    # int8 convs fold nothing
    k12 = tuple(ks.Counter() for _ in range(5))
    ks.quant_shapes("int8", k12=k12)
    assert not k12[4] and ks.by_prologue(k12[3]) == {"none": 57, "bias": 0}


def test_preset_k5_checks_keep_each_epilogue_and_whole_batches():
    """chip_smoke.py's phase 19 checks K5 at each (segments, Z, epilogue,
    prologue) the presets' chains launch that phase 3 does not, with the
    batches of the launches' scale and shift: the 609882 chain's SiLU in
    staged, the Z = 8 preset's modulate (after in_conv's bias) in staged
    over many batches; each check cut to at most K5_PRESET_ROWS rows
    keeps whole batches.  Every modulate of a generation chain adds the
    bias, no SiLU does."""
    import chip_smoke as cs
    shapes = [s for s, _ in cs.preset_kernel_shapes(cs.kernel_shapes())[
        "K5"]]
    keys = [s[1:4] + s[5:] for s in shapes]
    assert len(keys) == len(set(keys))
    assert not set(keys) & {s[1:4] + s[5:]
                            for s in cs.k5_shapes(acts=True)}
    assert {s[3] for s in shapes} == {"silu", "modulate_silu"}
    assert (5184, (512, 500), 2, "silu", 0, "none") in shapes
    mod = [s for s in shapes if s[3] == "modulate_silu"]
    assert (8192, (512,), 8, "modulate_silu", 128, "bias") in mod
    assert {s[5] for s in mod} == {"bias"}
    assert {s[5] for s in shapes if s[3] == "silu"} == {"none"}
    assert any(k5.grouped_variant(z, segs, 2, True, a) == "staged"
               for _, segs, z, a, _, _ in mod)
    for n, segs, z, act, b, _ in shapes:
        assert (b > 0 and n % b == 0) == (act == "modulate_silu")
        rows, keep = cs.preset_k5_cut(n, act, b)
        if act == "modulate_silu":
            assert 1 <= keep <= b and rows == keep * (n // b)
            assert rows <= max(cs.K5_PRESET_ROWS, n // b)
        else:
            assert rows == min(n, cs.K5_PRESET_ROWS) and keep == 0


def test_preview_gives_k5_a_float32_weight_with_an_epilogue(monkeypatch,
                                                           tmp_path):
    """``Trainer.preview`` samples the packed training model (float32
    master weights, bf16 activations) under ``torch.no_grad()``: the
    dispatcher's one K5 launch with its epilogue then reads a float32
    weight of a bf16 x, which ``grouped_rmsnorm_cuda`` rounds to bf16
    for the vector variant."""
    from tera_mind_tpu_torch.config import TrainConfig
    from tera_mind_tpu_torch.training import harness as th
    seen = set()
    real = tpk.grouped_rmsnorm_act

    def spy(x, weight, z, segments, eps=1e-6, from_5d=False, act="none",
            scale=None, shift=None, bias=None):
        mod = [t for t in (scale, shift) if t is not None]
        seen.add((x.dtype, weight.dtype, act,
                  _build.autograd_required(x, weight, *mod)))
        return real(x, weight, z, segments, eps, from_5d, act, scale,
                    shift, bias)

    monkeypatch.setattr(tpk, "grouped_rmsnorm_act", spy)
    conf = TrainConfig(image_size=32, net_ch=8, embed_channels=32,
                       rna_num=16, rna_slices=4, stain="all", batch_size=2,
                       accum_batches=1, compute_dtype="bfloat16",
                       train_crop=64, packed_compute=True, T_eval=2,
                       sample_size=1)
    tr = th.Trainer(conf, device="cpu")
    state = tr.init_state()
    rng = np.random.default_rng(0)
    crop, gh = conf.train_crop, conf.train_crop // 16 + conf.gn_sz
    batch = {"image": rng.standard_normal(
        (1, crop, crop, conf.in_channels)).clip(-1, 1).astype(np.float32),
        "rna": rng.integers(0, 3, (1, gh, gh, 4 * conf.rna_num)
                            ).astype(np.float32)}
    tr.preview(state, batch, str(tmp_path / "s"), step=1)
    for act in ("silu", "modulate_silu"):
        assert (torch.bfloat16, torch.float32, act, False) in seen, seen


# ------------------------------------------------------------------ #
# routing, the autograd guard and the counters                        #
# ------------------------------------------------------------------ #
def test_dispatcher_takes_the_function_only_when_autograd_records():
    x = torch.from_numpy(inputs((8, 16), 2, False, 5)[0])
    w = torch.nn.Parameter(torch.ones(48))
    before = (k5.launches, k5.bwd.launches)
    y = k5.grouped_rmsnorm_act(x, w, 2, (8, 16))
    assert type(y.grad_fn).__name__ == "GroupedRMSNormFunctionBackward"
    y.sum().backward()
    assert torch.equal(w.grad, k5.grouped_rmsnorm_bwd_plain(
        x, torch.ones_like(x), w, 2, (8, 16))[1])
    with torch.no_grad():
        assert k5.grouped_rmsnorm_act(x, w, 2, (8, 16)).grad_fn is None
    assert k5.grouped_rmsnorm_act(x, w.detach(), 2, (8, 16)).grad_fn is None
    assert (k5.launches, k5.bwd.launches) == before   # no launch on a CPU
    meta = torch.empty(2, 48, device="meta")
    with pytest.raises(RuntimeError, match="K5b"):
        k5.grouped_rmsnorm_cuda(meta, torch.nn.Parameter(
            torch.ones(48, device="meta")), 2, (8, 16))
    with pytest.raises(RuntimeError, match="no path"):
        k5.grouped_rmsnorm_act(meta, w, 2, (8, 16))
    with pytest.raises(ValueError):
        k5.grouped_rmsnorm_plain(x, w, 2, (8, 15))


def test_counters_reset_by_variant():
    k5.reset_launches()
    _build.count_launch(k5, "vector")
    _build.count_launch(k5.bwd, "staged")
    assert (k5.launches, k5.launches_by_variant) == (
        1, {"staged": 0, "vector": 1})
    assert k5.bwd.launches_by_variant == {"staged": 1, "vector": 0}
    k5.reset_launches()
    assert k5.launches == k5.bwd.launches == 0
    assert set(k5.launches_by_variant.values()) == {0}


def test_launcher_checks_its_limits_before_a_launch():
    """What the C entry points refuse is refused in Python first, with no
    library loaded: too many planes or segments, a row over kMaxWidth, a
    weight of the other layout, a g of another dtype."""
    for z, segs, wlen in ((9, (8,), 72), (2, (8, 8, 8, 8), 64),
                          (2, (6200,), 12400), (2, (8, 16), 24)):
        x = torch.zeros(1, z * sum(segs))
        with pytest.raises(ValueError):
            k5.grouped_rmsnorm_cuda(x, torch.ones(wlen), z, segs)
    x = torch.zeros(3, 48)
    with pytest.raises(ValueError, match="is not x's"):
        k5.grouped_rmsnorm_bwd_cuda(x, x.bfloat16(), torch.ones(48), 2,
                                    (8, 16))


# ------------------------------------------------------------------ #
# the variant rule and the layouts the kernels compute                #
# ------------------------------------------------------------------ #
def _kernel_shapes():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    return ks


def path_layouts():
    """Every (z, segments) the generation and training paths give K5 for
    the three presets' and the 8- and 16-slice variants' models."""
    ks = _kernel_shapes()
    out = set()
    for flags in ({}, {"mouse": "609882"}, {"rna_slc": 8},
                  {"mouse": "609889", "patch": 32, "to_hbr": True,
                   "stain": "DAPI", "rna_slc": 16},
                  {"mouse": "609889", "patch": 128, "to_hbr": True}):
        conf = ks.preset_conf(**flags)
        k5s = ks.Counter()
        ks.per_call_shapes(conf=conf, grid=(2, 2), k5=k5s)
        out |= {(z, segs) for _, segs, z in k5s}
    return sorted(out)


def test_variant_rule_on_every_path_layout():
    """bf16 rows whose segments are all multiples of 8 and of at most
    1,024 elements take ``vector`` when aligned; the 229-, 500- and
    81-gene segments' rows and wider rows ``staged``; float32 halves the
    row, and takes ``staged`` with an epilogue; misaligned tensors are
    ``staged``.  Every path layout fits the kernels' limits."""
    layouts = path_layouts()
    assert {z for z, _ in layouts} == {2, 4, 8}
    seen = set()
    for z, segs in layouts:
        width = z * sum(segs)
        assert z <= k5.MAX_Z and len(segs) <= k5.MAX_SEGMENTS
        assert width <= k5.MAX_WIDTH
        even = all(c % 8 == 0 for c in segs)
        want = "vector" if even and width <= 1024 else "staged"
        assert k5.grouped_variant(z, segs, 2, True) == want
        assert k5.grouped_variant(z, segs, 4, True) == (
            "vector" if even and width <= 512 else "staged")
        assert k5.grouped_variant(z, segs, 2, False) == "staged"
        # the epilogues: bf16 keeps its variant, float32 rows take staged
        for act in ("silu", "modulate_silu"):
            assert k5.grouped_variant(z, segs, 2, True, act) == want
            assert k5.grouped_variant(z, segs, 4, True, act) == "staged"
        seen.add(want)
    assert seen == {"vector", "staged"}
    assert max(z * sum(s) for z, s in layouts) == 8840


def vector_lanes(z, segments, itemsize, from_5d):
    """The vector variant's per-lane plan, as ``VecPlan`` in
    csrc/grouped_rmsnorm.cuh finds it: for lane ``sub`` of a row's G
    lanes, [(vector index, plane, weight vector index)] of its vectors
    sub, sub + G, ...; each vector's elements checked to lie in one plane
    and to read E consecutive weights from a 16-byte vector."""
    e = 16 // itemsize
    width = z * sum(segments)
    g = vector_group(width, itemsize)
    plane, widx = k5.element_planes(z, segments, from_5d)
    out = []
    for sub in range(g):
        mine = []
        for vi in range(sub, width // e, g):
            p, w = plane[vi * e: vi * e + e], widx[vi * e: vi * e + e]
            assert bool((p == p[0]).all()) and int(w[0]) % e == 0
            assert bool((w == w[0] + torch.arange(e)).all()), (vi, p, w)
            mine.append((vi, int(p[0]), int(w[0]) // e))
        out.append(mine)
    return out


@pytest.mark.parametrize("z,segs", [(2, (128, 64, 32)), (2, (64,)),
                                    (4, (128, 128)), (8, (8, 16, 8)),
                                    (1, (8,)), (2, (512,))])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("from_5d", [False, True])
def test_vector_lane_plan(z, segs, itemsize, from_5d):
    """The vector variant's plan (``VecPlan``): each 16-byte vector lies
    in one plane and reads E consecutive weights that start on a
    16-byte vector; a lane holds at most ``kVecMax`` vectors and the
    lanes of a row hold each vector once."""
    width = z * sum(segs)
    if k5.grouped_variant(z, segs, itemsize, True) != "vector":
        assert width * itemsize > k5.VEC_MAX_ROW_BYTES   # the only reason
        return
    lanes = vector_lanes(z, segs, itemsize, from_5d)
    assert len(lanes) == vector_group(width, itemsize)
    assert all(len(v) <= 4 for v in lanes)
    held = sorted(vi for v in lanes for vi, _, _ in v)
    assert held == list(range(width * itemsize // 16))


def staged_visits(z, segs, itemsize=2):
    """K5b staged's walk (``csrc/grouped_rmsnorm_bwd.cu``): a block a
    row, thread t owning elements t, t + T, ... (at most ``ept``) of every
    row: element -> (thread, plane found by ``locate``)."""
    ept, threads, _ = k5.bwd_staged_plan(z * sum(segs), itemsize)
    width = z * sum(segs)
    seen = {}
    for tid in range(threads):
        for k in range(ept):
            e = tid + k * threads
            if e >= width:
                continue
            s, off = 0, 0
            while s + 1 < len(segs) and e >= off + z * segs[s]:
                off += z * segs[s]
                s += 1
            assert e not in seen
            seen[e] = (tid, (e - off) // segs[s])
    return seen, threads


@pytest.mark.parametrize("z", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("segs", [(229,), (512, 256, 229), (81, 8), (7,)])
def test_staged_plane_groups_cover_each_element_once(z, segs):
    """Every element of a row is owned by exactly one thread of K5b's
    staged block, which finds its plane (the plane of
    ``element_planes``) once for every row, whole warps a block, so each
    element's dw sum has one owner and stays in its registers."""
    seen, threads = staged_visits(z, segs)
    plane, _ = k5.element_planes(z, segs, False)
    assert sorted(seen) == list(range(z * sum(segs)))
    assert all(seen[e][1] == int(plane[e]) for e in seen)
    assert threads % 32 == 0 and threads <= k5.BWD_MAX_THREADS


def test_dw_fold_of_the_5d_weight():
    """from_5d, element (s, z, j) reads weight channel cum_s + j, so dw
    sums the planes' elements into (Ctot,): ``element_planes``' weight
    index is the fold grouped_bwd_dw_kernel takes (base off_s + j, step
    c_s, Z planes)."""
    z, segs = 4, (16, 8, 7)
    _, widx = k5.element_planes(z, segs, True)
    off = cum = 0
    for c in segs:
        for k in range(cum, cum + c):
            els = [off + k - cum + zz * c for zz in range(z)]
            assert [int(widx[e]) for e in els] == [k] * z
        off += z * c
        cum += c
    assert torch.equal(k5.element_planes(z, segs, False)[1],
                       torch.arange(z * sum(segs)))


def test_staged_blocks_and_bwd_grid():
    """K5b's grid, the rows of its dw partials (``bwd_blocks``): K5b
    staged's threads and shared memory a block, and no more blocks than
    the card holds at once."""
    # 970 bf16 elements: at most 123 words; a block a row, 8 elements a
    # thread up to 4,096 wide: x and g words in two slots, each warp's two
    # sums a plane
    assert k5.bwd_staged_plan(970, 2) == (8, 128, 4 * 1968 + 4 * 4 * 16)
    assert k5.bwd_staged_plan(2506, 2) == (8, 320, 4 * 5040 + 4 * 10 * 16)
    # the widest float32 row of the presets: 24 elements a thread, 2,211
    # words; kMaxWidth: 3,073 words
    assert k5.bwd_staged_plan(8840, 4) == (24, 384,
                                           4 * 16 * 2211 + 4 * 12 * 16)
    assert k5.bwd_staged_plan(k5.MAX_WIDTH, 4) == (
        24, 512, 4 * 16 * 3073 + 4 * 16 * 16)
    assert k5.bwd_blocks(1, "staged", 970, 2, 132) == 1
    assert k5.bwd_blocks(10 ** 6, "staged", 970, 2, 132) == \
        k5.BWD_MAX_BLOCKS
    assert k5.bwd_blocks(10 ** 6, "staged", 1792, 2, 132) == 4 * 132
    assert k5.bwd_blocks(10 ** 6, "staged", 2506, 2, 132) == 3 * 132
    # 448 bf16 channels: 56 vectors, 16 lanes a row, 16 rows a block
    assert k5.bwd_blocks(100, "vector", 448, 2, 132) == 7
    assert k5.bwd_blocks(10 ** 6, "vector", 448, 2, 132) == 2 * 132
    assert k5.bwd_blocks(10 ** 7, "vector", 448, 2, 1000) == \
        k5.BWD_MAX_BLOCKS


def test_wrapper_mirrors_the_sources():
    """The constants the wrapper mirrors are the sources' own, and the
    build compiles both files into the one library."""
    cuh = (_build.CSRC / "grouped_rmsnorm.cuh").read_text()
    fwd = (_build.CSRC / "grouped_rmsnorm.cu").read_text()
    bwd = (_build.CSRC / "grouped_rmsnorm_bwd.cu").read_text()
    for line in (f"constexpr int kMaxZ = {k5.MAX_Z};",
                 f"constexpr int kMaxSegments = {k5.MAX_SEGMENTS};",
                 f"constexpr int kMaxWidth = {k5.MAX_WIDTH};",
                 f"constexpr int kThreads = {k5.THREADS};",
                 "constexpr int kVecMax = 4;",
                 "constexpr int kVecMaxBytes = 32 * kVecMax * 16;",
                 "enum : int { kStaged = 0, kVector = 1 };"):
        assert line in cuh, line
    assert 32 * 4 * 16 == k5.VEC_MAX_ROW_BYTES
    assert k5.VARIANTS == ("staged", "vector")
    assert "constexpr int kMaxBlocks = 8 * 132;" in bwd
    assert k5.BWD_MAX_BLOCKS == 8 * 132
    # the vector kernels' blocks an SM, which the bwd grid's cap assumes
    assert re.search(r"__launch_bounds__\(kThreads, 2\)\s*"
                     r"grouped_bwd_vec_kernel", bwd)
    assert k5.BWD_VEC_BLOCKS_PER_SM == 2
    assert re.search(r"__launch_bounds__\(kBwdMaxThreads, EPT == 8 \? 2 : "
                     r"1\)\s*grouped_bwd_staged_kernel", bwd)
    assert f"constexpr int kBwdMaxThreads = {k5.BWD_MAX_THREADS};" in cuh
    assert "return w <= 8 * kBwdMaxThreads ? 8 : w <= 16 * kBwdMaxThreads" \
        " ? 16 : 24;" in cuh
    # the registers bwd_blocks assumes: 65,536 over 512 threads, 2 or 1
    # blocks (the bounds above)
    assert 65536 // (k5.BWD_MAX_THREADS * 2) == 64
    assert "return 2 * 2 * kWordBytes * staged_words<T>(w) +" in cuh
    assert f"constexpr int kSmSmem = {k5.SM_SMEM};" in cuh
    for line in ("const int by_smem = kSmSmem / (smem + 1024);",
                 "const int by_threads = 2048 / threads;",
                 "const int by_regs = 65536 / (threads * regs);"):
        assert line in cuh, line
    assert k5.EPILOGUES == ("none", "silu", "modulate_silu")
    assert ("enum : int { kActNone = 0, kActSilu = 1, kActModulateSilu = 2 "
            "};") in cuh
    assert "while (g < 32 && g * kVecMax < nvec) g *= 2;" in cuh
    assert "#include \"rmsnorm_words.cuh\"" in cuh
    for src in (fwd, bwd):
        assert "#include \"grouped_rmsnorm.cuh\"" in src
        assert "unet_packed.py:85-108" in src
    assert {p.name for p in _build.sources()} >= {
        "grouped_rmsnorm.cu", "grouped_rmsnorm_bwd.cu",
        "grouped_rmsnorm.cuh"}
    assert len(_build.SIGNATURES["tmt_grouped_rmsnorm"]) == 21
    # the prologue's bias pointer follows the weight's
    assert re.search(r"tmt_grouped_rmsnorm\(const void\* x, const void\* w,"
                     r"\s*const void\* bias, void\* y,", fwd)
    assert k5.PROLOGUES == ("none", "bias")
    assert len(_build.SIGNATURES["tmt_grouped_rmsnorm_bwd"]) == 18

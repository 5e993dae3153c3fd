"""int8 inference in the port against the JAX package, on the CPU.

``tera_mind_tpu_torch/ops/quant.py`` (quantize, the int8 conv and dense,
``prequantize_params``, ``to_inference_dtype``, ``bake_act_scales``,
``calibrate_generator``), the quantized packed model and ``convert``'s
int8 trees, held against ``tera_mind_tpu/ops/quant.py`` and its packed
model on the same numpy inputs: int8 values, scales and int32 sums
bit-equal, dequantized outputs within 1e-6 of their max (JAX's own
off-TPU tolerance, tests/test_quant.py:219).  Then tests/test_quant.py's
quality gates on the port alone, the layout and variant helpers of
``ops/quant_kernel.py``, its counters, its refusal of autograd and the
CLI's ``--quant``.  K3 and K4 run only on the card: chip_smoke.py holds
them against the plain versions these tests exercise.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import GKW, MKW, gene_grid
from test_torch_models import GOLDEN_KW, randn, seeded_params, t

from tera_mind_tpu.diffusion.sampler import DiffusionSampler as JSampler
from tera_mind_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from tera_mind_tpu.diffusion.schedule import spaced_schedule as j_spaced
from tera_mind_tpu.models import unet_packed as jpk
from tera_mind_tpu.models.unet import TeraUNetConfig as JUNetConfig
from tera_mind_tpu.ops import quant as jq
from tera_mind_tpu.parallel import generator as jgen
from tera_mind_tpu_torch.cli import generate as tcli
from tera_mind_tpu_torch.convert import export_params, load_jax_params
from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                   SamplerConfig)
from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
from tera_mind_tpu_torch.models import unet_packed as tpk
from tera_mind_tpu_torch.models.nn import init_weights
from tera_mind_tpu_torch.models.unet import TeraUNetConfig as TUNetConfig
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import quant as tq
from tera_mind_tpu_torch.ops import quant_kernel as qk
from tera_mind_tpu_torch.parallel import generator as tgen

OUT_TOL = 1e-6   # dequantized outputs: of their max |ref|
# The quantized packed model against JAX's on the same parameters and
# inputs, both float32 on the CPU.  Each quantized layer, given the input
# JAX gave its counterpart, must return JAX's output within OUT_TOL (in
# practice bit for bit).  The whole models differ more: a sum in another
# order (1e-6 of the float model's output) moves an activation across a
# rounding boundary of its int8 grid, which changes it by a whole step,
# and over 77 requantized convolutions (and 42 denses) such flips cascade:
# the first run measured 0.051-0.077 of the output's max (0.0056 mean),
# and the port against itself with every weight moved by 1e-7 of itself
# 0.045 (0.0056 mean).  So the whole output is held to the port's own
# noise floor, measured that way in the test: within NOISE_FACTOR of it,
# and within tests/test_quant.py's int8 gates (0.15 max, 0.02 mean).
NOISE_FACTOR = 3.0
NOISE_REL = 1e-7
# The share of the quantized layers' int8 inputs that differ from JAX's
# must stay within FLIP_FACTOR of the share that the same 1e-7 move makes
# differ (set before its first run): a systematic error anywhere in the
# unquantized parts moves more of them than the rounding cascade does.
FLIP_FACTOR = 2.0
# calibrated scales, port against JAX, over the same 3-step chain (set
# before the first run): the chains reach the abs-maxes through the same
# activations up to the rounding flips above
SCALE_RTOL = 5e-2
# tests/test_quant.py's chain gates
CHAIN_MEAN, CHAIN_CORR, CHAIN_SHIFT, CHAIN_STD = 0.03, 0.99, 0.01, 0.02


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: tier-1 runs several pytest
    workers on one host, and their torch thread pools, each as large as
    the host's cores, then oversubscribe it (small CPU ops ran up to 100x
    slower under four workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def j_static_q(x, a_scale):
    """JAX's a_scale branch of quant_conv2d / quant_dense (:84-87)."""
    sx = jnp.asarray(a_scale, jnp.float32)
    return jnp.clip(jnp.round(jnp.asarray(x).astype(jnp.float32) / sx),
                    -127, 127).astype(jnp.int8)


def close_to_max(got, want, tol=OUT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


# --------------------------------------------------------------------- #
# quantize, the int8 conv and dense: bit-equal to JAX                    #
# --------------------------------------------------------------------- #
def _quant_inputs(case):
    rng = np.random.default_rng(0)
    if case == "ties":
        # (k + 1/2) * 2^-3 for k in -127..126 and the abs-max 127 * 2^-3:
        # the scale is 2^-3 exactly and every x / s is a half-way tie
        x = np.concatenate([(np.arange(-127, 127) + 0.5) * 0.125,
                            [127 * 0.125]]).astype(np.float32)
        return rng.permutation(x).reshape(5, 51), np.float32
    x = randn(rng, 4, 6, 7, 10)
    if case == "bf16":
        return x, jnp.bfloat16
    return x, np.float32


@pytest.mark.parametrize("case", ["randn", "ties", "bf16"])
def test_quantize_tensor_matches_jax(case):
    x, dt = _quant_inputs(case)
    jx = jnp.asarray(x, dt)
    want_q, want_s = jq.quantize_tensor(jx)
    tx = t(np.asarray(jx.astype(jnp.float32)))
    if dt == jnp.bfloat16:
        tx = tx.to(torch.bfloat16)
    q, s = tq.quantize_tensor(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    assert s.numpy() == np.asarray(want_s)
    if case == "ties":
        assert float(s) == 0.125
        np.testing.assert_array_equal(q.numpy(), np.round(x / 0.125))
    # the static branch: a scale that saturates the largest values
    a = np.float32(np.abs(x).max() / 200)
    qs, ss, amax = qk.quantize_plain(tx, torch.tensor(a), 8)
    assert amax is None and float(ss) == a
    want = np.asarray(j_static_q(jx, a))
    assert np.abs(want).max() == 127
    np.testing.assert_array_equal(qs[..., :x.shape[-1]].numpy(), want)
    assert not qs[..., x.shape[-1]:].any()


@pytest.mark.parametrize("static", [False, True])
def test_quantize_propagates_nan_as_jax_does(static):
    """A NaN input: JAX's dynamic scale is NaN and every int8 value 0
    (XLA converts a NaN to 0); with a static scale only the NaN's value is
    0.  K4 does the same on the card (chip_smoke.py)."""
    x = randn(np.random.default_rng(2), 6, 10)
    x[2, 3] = np.nan
    if static:
        want_q, want_s = j_static_q(jnp.asarray(x), 0.05), np.float32(0.05)
        q, s, amax = qk.quantize_plain(t(x), torch.tensor(0.05), 8)
        assert amax is None and int(q[2, 3]) == 0
    else:
        want_q, want_s = jq.quantize_tensor(jnp.asarray(x))
        q, s, amax = qk.quantize_plain(t(x), None, 8)
        assert np.isnan(float(amax)) and np.isnan(float(s))
        assert not q.any()
    np.testing.assert_array_equal(q[:, :10].numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert not q[:, 10:].any()


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (229, 64)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(1)
    w = (randn(rng, *shape) * rng.uniform(0.1, 10, shape[-1])).astype(
        np.float32)
    want_q, want_s = jq.quantize_weight(jnp.asarray(w))
    wt = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T   # port layout
    q, s = tq.quantize_weight(t(np.ascontiguousarray(wt)))
    back = q.numpy().transpose(2, 3, 1, 0) if w.ndim == 4 else q.numpy().T
    np.testing.assert_array_equal(back, np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def _jax_int32_conv(xq, wq_hwio, k):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq_hwio), (1, 1),
        [((k - 1) // 2,) * 2] * 2, dimension_numbers=("NHWC", "HWIO",
                                                       "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("mode", ["dynamic", "prequant_static"])
@pytest.mark.parametrize("ci", [10, 18])
@pytest.mark.parametrize("k", [3, 1])
def test_quant_conv2d_matches_jax(k, ci, mode):
    rng = np.random.default_rng(k * 100 + ci)
    x = randn(rng, 2, 9, 7, ci)
    w = randn(rng, k, k, ci, 24, scale=0.2)
    b = randn(rng, 24)
    pad = [((k - 1) // 2,) * 2] * 2
    jx = jnp.asarray(x)
    xq, sx = jq.quantize_tensor(jx)
    wq, sw = jq.quantize_weight(jnp.asarray(w))
    kw, a_scale = {}, None
    if mode == "prequant_static":
        a_scale = np.float32(np.abs(x).max() / 90)   # saturates the top
        kw = dict(w_q=wq, w_scale=sw, a_scale=jnp.asarray(a_scale))
    want = jq.quant_conv2d(jx, jnp.asarray(w), jnp.asarray(b), pad,
                           out_dtype=jnp.float32, **kw)
    tw = t(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    tkw = {}
    if mode == "prequant_static":
        tkw = dict(w_q=t(np.ascontiguousarray(
            np.asarray(wq).transpose(3, 0, 1, 2))), w_scale=t(np.asarray(sw)),
            a_scale=torch.tensor(a_scale))
    got = tq.quant_conv2d(t(x), tw, t(b), pad, out_dtype=torch.float32,
                          **tkw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    close_to_max(got.numpy(), want)
    # the int8 operands and the int32 sums, bit for bit
    jxq = xq if a_scale is None else j_static_q(jx, a_scale)
    pxq, _, _ = qk.quantize(t(x), None if a_scale is None
                            else torch.tensor(a_scale), qk.CONV_ALIGN)
    np.testing.assert_array_equal(pxq[..., :ci].numpy(), np.asarray(jxq))
    pwq = qk.pad_last(t(np.ascontiguousarray(
        np.asarray(wq).transpose(3, 0, 1, 2))), qk.CONV_ALIGN)
    acc = qk.quant_conv_plain(pxq, pwq, out_dtype=torch.int32)
    np.testing.assert_array_equal(acc.numpy(), _jax_int32_conv(jxq, wq, k))


@pytest.mark.parametrize("mode", ["dynamic", "prequant_static"])
@pytest.mark.parametrize("kin", [229, 64])
def test_quant_dense_matches_jax(kin, mode):
    rng = np.random.default_rng(kin)
    x = randn(rng, 3, 11, kin)
    w = randn(rng, kin, 40, scale=0.1)
    b = randn(rng, 40)
    jx = jnp.asarray(x)
    wq, sw = jq.quantize_weight(jnp.asarray(w))
    kw, tkw, a_scale = {}, {}, None
    if mode == "prequant_static":
        a_scale = np.float32(np.abs(x).max() / 100)
        kw = dict(w_q=wq, w_scale=sw, a_scale=jnp.asarray(a_scale))
        tkw = dict(w_q=t(np.ascontiguousarray(np.asarray(wq).T)),
                   w_scale=t(np.asarray(sw)), a_scale=torch.tensor(a_scale))
    want = jq.quant_dense(jx, jnp.asarray(w), jnp.asarray(b),
                          out_dtype=jnp.float32, **kw)
    got = tq.quant_dense(t(x), t(np.ascontiguousarray(w.T)), t(b),
                         out_dtype=torch.float32, **tkw)
    assert got.shape == want.shape
    close_to_max(got.numpy(), want)
    jxq = jq.quantize_tensor(jx)[0] if a_scale is None \
        else j_static_q(jx, a_scale)
    pxq, _, _ = qk.quantize(t(x).reshape(-1, kin), None if a_scale is None
                            else torch.tensor(a_scale), qk.MM_ALIGN)
    assert pxq.shape[-1] == qk.round_up(kin, 8)
    np.testing.assert_array_equal(pxq[:, :kin].numpy(),
                                  np.asarray(jxq).reshape(-1, kin))
    acc = qk.int8_mm(pxq, qk.pad_last(t(np.ascontiguousarray(
        np.asarray(wq).T)), qk.MM_ALIGN))
    want_acc = jax.lax.dot_general(jxq.reshape(-1, kin), wq,
                                   (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))


# --------------------------------------------------------------------- #
# parameter trees: prequantize, convert, bake, inference dtype          #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def quant_case():
    """Inputs, a seeded 5D flax tree, JAX's packed tree of it, JAX's
    prequantized trees (ResBlock convs; and the DiT denses), an abs-max
    record of the port's prequantized model on the inputs and JAX's static
    tree baked from it."""
    rng = np.random.default_rng(20)
    x = randn(rng, 4 * 9, 32, 32, 4)
    rna = ((rng.random((36, 2, 2, 64)) < 0.2) * 3).astype(np.float32)
    ts = np.array([500, 20, 999, 0], np.int32)
    jconf = JUNetConfig(**GOLDEN_KW, dropout=0.0)
    p5 = f32_tree(seeded_params(jconf.make_model(), x[:4], ts[:1], rna[:4],
                                2, 2, seed=21))
    pp = jpk.pack_unet_params(p5, jconf)
    pq = {attn: f32_or_int8(jq.prequantize_params(pp, attn=attn))
          for attn in (False, True)}
    model = port_model(pq[True], quant="int8", prequant=True,
                       quant_attn=True)
    with tq.recording(model) as accum, torch.no_grad():
        model(t(x), t(ts).long(), t(rna), 3, 3)
    static = f32_or_int8(jq.bake_act_scales(pq[True], accum))
    return x, rna, ts, p5, pp, pq, accum, static


def f32_or_int8(tree):
    return jax.tree.map(lambda a: np.asarray(
        a, np.int8 if np.asarray(a).dtype == np.int8 else np.float32), tree)


def port_model(tree, **kw):
    return load_jax_params(tpk.make_packed_model(TUNetConfig(**GOLDEN_KW),
                                                 **kw), tree).eval()


@pytest.mark.parametrize("attn", [False, True])
def test_prequantize_params_matches_jax(quant_case, attn):
    """On JAX's packed tree carried across by convert (loaded into the
    port's float model and exported): the same selection (ResBlock convs;
    with attn the DiT denses, never the stem, out_conv or gene block),
    int8 values and scales."""
    _, _, _, _, pp, pq, _, _ = quant_case
    carried = export_params(port_model(pp))
    got = tq.prequantize_params(carried, attn=attn)
    assert_trees_equal(got, pq[attn])
    names = [k for k in flat(got) if k.endswith("kernel_q")]
    blocks = [k.split("/")[2] for k in names]     # /params/<block>/...
    assert all(tq._RESBLOCK.match(b) or (attn and tq._ATTNBLOCK.match(b))
               for b in blocks)
    assert len(names) == 77 + (42 if attn else 0)   # GOLDEN_KW


@pytest.mark.parametrize("static", [False, True])
def test_convert_carries_jax_int8_trees(quant_case, static):
    """JAX's prequantized tree (and its static tree with a_scale leaves)
    loads into the port's quant model and exports back bit for bit; the
    K3 kernel_q buffers hold the input channels zero-padded to K3's
    multiple (``conv_align``: 16 at these widths), the dense ones to 8,
    and the scales stay float32."""
    _, _, _, _, _, pq, _, stree = quant_case
    tree = stree if static else pq[True]
    model = port_model(tree, quant="int8", prequant=True, quant_attn=True,
                       static_act=static)
    assert_trees_equal(export_params(model), tree)
    for m in model.modules():
        if isinstance(m, tq.QuantModule):
            ci = m.in_channels
            align = (qk.conv_align(ci) if isinstance(m, tpk.QuantConv2p)
                     else 8)
            assert m.kernel_q.shape[-1] == qk.round_up(ci, align)
            assert not m.kernel_q[..., ci:].any()
            assert m.w_scale.dtype == torch.float32
    # a ragged conv: Ci = 18 is stored as 32 channels, exported as 18
    conv = tpk.QuantConv2p(18, 24, (3, 3), prequant=True)
    rng = np.random.default_rng(2)
    small = {"kernel_q": rng.integers(-127, 128, (3, 3, 18, 24)).astype(
        np.int8), "w_scale": rng.random(24).astype(np.float32),
        "bias": randn(rng, 24)}
    load_jax_params(conv, small)
    assert conv.kernel_q.shape == (24, 3, 3, 32)
    assert not conv.kernel_q[..., 18:].any()
    assert_trees_equal(export_params(conv), {"params": small})
    with pytest.raises(KeyError):
        port_model(pq[True], quant="int8", prequant=True, quant_attn=True,
                   static_act=True)    # no a_scale leaves


def test_to_inference_dtype_keeps_int8_and_f32_scales(quant_case):
    _, _, _, _, _, _, _, stree = quant_case
    model = port_model(stree, quant="int8", prequant=True, quant_attn=True,
                       static_act=True)
    before = {n: b.clone() for n, b in model.named_buffers()}
    tq.to_inference_dtype(model, torch.bfloat16)
    assert model.dec_0_res.in_conv.bias.dtype == torch.bfloat16
    assert model.dec_0_res.in_conv.dtype == torch.bfloat16
    for name, buf in model.named_buffers():
        assert buf.dtype == before[name].dtype and torch.equal(
            buf, before[name]), name
    model.to(torch.float16).float()     # any later cast keeps them too
    for name, buf in model.named_buffers():
        assert torch.equal(buf, before[name]), name


def test_bake_act_scales_matches_jax(quant_case):
    _, _, _, _, _, pq, accum, stree = quant_case
    assert all(k[0] == "calib" and k[-1] == "a_max" for k in accum)
    assert ("calib", "mid_attn", "attn", "q", "a_max") in accum
    assert ("calib", "enc_1_res", "in_conv", "a_max") in accum
    got = tq.bake_act_scales(pq[True], accum)
    assert_trees_equal(f32_or_int8(got), stree)
    half = tq.bake_act_scales(pq[True], accum, margin=0.5)
    want = f32_or_int8(jq.bake_act_scales(pq[True], accum, margin=0.5))
    assert_trees_equal(f32_or_int8(half), want)


# --------------------------------------------------------------------- #
# the quantized packed model against JAX's                               #
# --------------------------------------------------------------------- #
VARIANTS = {   # name: (tree, PackedTeraUNet options)
    "dynamic": ("pp", dict(quant="int8")),
    "from_5d": ("p5", dict(quant="int8", from_5d=True)),
    "prequant_attn": ("pq", dict(quant="int8", prequant=True,
                                 quant_attn=True)),
    "static_attn_packed": ("static", dict(quant="int8", prequant=True,
                                          static_act=True, quant_attn=True,
                                          packed_attn=True)),
}


def jax_layers(monkeypatch, jm, tree, x, ts, rna):
    """JAX's outputs of ``jm`` (jitted) and, in call order, every
    quant_conv2d and quant_dense call inside it: its input and the output
    JAX's function gives on that call's arguments, run op by op.  (XLA's
    fusion of the jitted model moves a few quantized values by one step
    against that: a rounding near a tie.)"""
    from jax.experimental import io_callback
    calls = []

    def record(fn):
        def wrapped(*args, **kw):
            y = fn(*args, **kw)
            flat, tree_ = jax.tree_util.tree_flatten((args, kw))
            dyn = [i for i, v in enumerate(flat)
                   if isinstance(v, (jax.Array, jax.core.Tracer))]

            def host(*vals):
                leaves = list(flat)
                for i, v in zip(dyn, vals):
                    leaves[i] = np.asarray(v)
                a, k = jax.tree_util.tree_unflatten(tree_, leaves)
                calls.append((fn, a, k))
            io_callback(host, None, *[flat[i] for i in dyn], ordered=True)
            return y
        return wrapped

    monkeypatch.setattr(jq, "quant_conv2d", record(jq.quant_conv2d))
    monkeypatch.setattr(jq, "quant_dense", record(jq.quant_dense))
    out = jax.jit(lambda q: jm.apply(q, x, ts, rna, 3, 3))(tree)
    jax.effects_barrier()
    return [np.asarray(o) for o in out], [
        (np.asarray(a[0]), np.asarray(fn(*a, **k))) for fn, a, k in calls]


def port_layers(model, x, ts, rna):
    """The port's outputs and, in call order, (module, input) of every
    quantized layer (QuantConv2p, QuantDense, Conv3DAsPacked's int8
    branch)."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.append(
        (mod, inp[0]))) for m in model.modules()
        if isinstance(m, tq.QuantModule) or (
            isinstance(m, tpk.Conv3DAsPacked) and m.quant)]
    with torch.no_grad():
        out = model(t(x), t(ts).long(), t(rna), 3, 3)
    for h in hooks:
        h.remove()
    return [o.numpy() for o in out], seen


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_packed_quant_model_matches_jax(quant_case, variant, monkeypatch):
    x, rna, ts, p5, pp, pq, _, stree = quant_case
    which, kw = VARIANTS[variant]
    tree = {"pp": pp, "p5": p5, "pq": pq[True], "static": stree}[which]
    jm = jpk.PackedTeraUNet(JUNetConfig(**GOLDEN_KW, dropout=0.0), **kw)
    want, jcalls = jax_layers(monkeypatch, jm, tree, x, ts, rna)
    model = port_model(tree, **kw)
    got, pcalls = port_layers(model, x, ts, rna)
    # the decoder's layers run twice (collage and original pass)
    assert len(jcalls) == len(pcalls) > 77 + (42 if kw.get("quant_attn")
                                              else 0)
    # every quantized layer, on JAX's input, gives JAX's output
    assert all(jo.dtype == np.float32 for _, jo in jcalls)
    flips = total = 0
    with torch.no_grad():
        for (mod, pin), (jin, jout) in zip(pcalls, jcalls):
            close_to_max(mod(t(jin.copy())).numpy(), jout)
            a, _ = tq.quantize_tensor(pin)
            b, _ = tq.quantize_tensor(t(jin.copy()))
            flips += int((a != b).sum())
            total += a.numel()
    # the whole model: within NOISE_FACTOR of the port's own response to a
    # 1e-7 relative move of every weight
    noisy = port_model(tree, **kw)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in noisy.parameters():
            p.mul_(1 + NOISE_REL * torch.randn(p.shape, generator=g))
    floor, ncalls = port_layers(noisy, x, ts, rna)
    nflips = sum(int((tq.quantize_tensor(a)[0] != tq.quantize_tensor(b)[0])
                     .sum()) for (_, a), (_, b) in zip(pcalls, ncalls))
    assert len(ncalls) == len(pcalls)
    for gt, w, f in zip(got, want, floor):
        assert np.isfinite(gt).all() and gt.shape == w.shape
        scale = np.abs(w).max()
        d, dn = np.abs(gt - w), np.abs(gt - f)
        report = (variant, d.max() / scale, d.mean() / scale,
                  dn.max() / scale, dn.mean() / scale, flips / total,
                  nflips / total)
        print("largest gap, mean gap, noise floor max and mean (of the "
              "output's max), share of int8 inputs that differ from JAX's "
              "and under the 1e-7 move:", report)
        assert flips <= FLIP_FACTOR * nflips, report
        assert d.max() <= NOISE_FACTOR * dn.max(), report
        assert d.mean() <= NOISE_FACTOR * dn.mean(), report
        assert d.max() < 0.15 * scale and d.mean() < 0.02 * scale, report


def test_quant_model_has_the_float_models_parameters():
    conf = TUNetConfig(**GOLDEN_KW)
    shapes = {n: p.shape for n, p in
              tpk.make_packed_model(conf).named_parameters()}
    for kw in (dict(quant="int8"), dict(quant="int8", quant_attn=True),
               dict(quant="int8", from_5d=True)):
        qm = tpk.make_packed_model(conf, **kw)
        if kw.get("from_5d"):
            shapes5 = {n: p.shape for n, p in tpk.make_packed_model(
                conf, from_5d=True).named_parameters()}
            assert {n: p.shape for n, p in qm.named_parameters()} == shapes5
        else:
            assert {n: p.shape for n, p in qm.named_parameters()} == shapes
        assert not list(qm.buffers())
    pre = tpk.make_packed_model(conf, quant="int8", prequant=True,
                                quant_attn=True)
    assert sum(isinstance(m, tpk.QuantConv2p) for m in pre.modules()) == 77
    assert sum(isinstance(m, tq.QuantDense) for m in pre.modules()) == 42
    assert not isinstance(pre.stem, tpk.QuantConv2p)
    assert not isinstance(pre.rna_tower.gene_attn.mlp.fc1, tq.QuantDense)


# --------------------------------------------------------------------- #
# calibration against JAX's                                              #
# --------------------------------------------------------------------- #
def test_calibrate_generator_matches_jax():
    """A 2x2-tile, 3-step chain of the dynamic prequantized model (DiT
    denses too): the same calibration keys as JAX's calibrate_generator,
    each scale within SCALE_RTOL of JAX's."""
    jconf = JUNetConfig(**MKW, dropout=0.0)
    p5 = f32_tree(seeded_params(
        jconf.make_model(), np.zeros((4, 32, 32, 2), np.float32),
        np.zeros((1,), np.int32), np.zeros((4, 2, 2, 24), np.float32), 2, 2,
        seed=5))
    pq = f32_or_int8(jq.prequantize_params(jpk.pack_unet_params(p5, jconf),
                                           attn=True))
    gconf = jgen.GeneratorConfig(**GKW, noise_backend="torch")
    gene = gene_grid(gconf)
    jm = jpk.PackedTeraUNet(jconf, quant="int8", prequant=True,
                            quant_attn=True)
    jg = jgen.TeraGenerator(
        JSampler(j_spaced("linear", 1000, "ddim3"),
                 JSamplerConfig(patch_size=32, gn_sz=2)),
        lambda p, xp, tm, rp, p1, p2: jm.apply(p, xp, tm, rp, p1, p2,
                                               decode_original=False),
        gconf, params=pq)
    want = flat(jq.calibrate_generator(jg, jm, pq, gene, steps=3, row0=1,
                                       col0=1, grid_w=16))

    model = load_jax_params(tpk.make_packed_model(
        TUNetConfig(**MKW), quant="int8", prequant=True, quant_attn=True),
        pq).eval()
    gen = tgen.TeraGenerator(
        DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                         SamplerConfig(patch_size=32, gn_sz=2)),
        lambda xp, tm, rp, p1, p2: model(xp, tm, rp, p1, p2,
                                         decode_original=False),
        tgen.GeneratorConfig(**GKW), device="cpu")
    got = flat(tq.calibrate_generator(gen, model, pq, gene, steps=3,
                                      row0=1, col0=1, grid_w=16))
    scales = sorted(k for k in want if k.endswith("a_scale"))
    assert sorted(k for k in got if k.endswith("a_scale")) == scales
    assert len(scales) == 53 + 28
    for k in scales:
        np.testing.assert_allclose(got[k], want[k], rtol=SCALE_RTOL,
                                   err_msg=k)
    assert not model.mid_attn.adaLN.calibrating


# --------------------------------------------------------------------- #
# tests/test_quant.py's gates on the port alone                          #
# --------------------------------------------------------------------- #
def test_quant_conv2d_close_to_f32():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 16, 16, 24)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 24, 40)) * 0.1).astype(
        np.float32)).permute(3, 2, 0, 1)
    b = torch.from_numpy(rng.standard_normal((40,)).astype(np.float32))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, b,
                                      padding=1).permute(0, 2, 3, 1)
    got = tq.quant_conv2d(x, w, b, [(1, 1), (1, 1)], out_dtype=torch.float32)
    d, denom = (got - want).abs(), want.abs().max()
    assert float(d.max() / denom) < 0.02
    assert float(d.mean() / denom) < 0.004


def _tiny(seed=3):
    """The port's packed tree of a seeded 5D init (GOLDEN_KW), inputs."""
    conf = TUNetConfig(**GOLDEN_KW, use_zero_module=False)
    tree = tpk.pack_unet_params(export_params(init_weights(
        conf.make_model(), seed)), conf)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 4), np.float32))
    rna = torch.from_numpy(((rng.random((4, 2, 2, 64)) < 0.2) * 2).astype(
        np.float32))
    return conf, tree, x, rna


def test_quant_model_close_to_exact_and_prequant_bit_equal():
    conf, tree, x, rna = _tiny()
    ts = torch.tensor([77])

    def run(tr, **kw):
        m = load_jax_params(tpk.make_packed_model(conf, **kw), tr).eval()
        with torch.no_grad():
            return m(x, ts, rna, 2, 2)

    exact = run(tree)
    dyn = run(tree, quant="int8", quant_attn=True)
    pre = run(tq.prequantize_params(tree, attn=True), quant="int8",
              prequant=True, quant_attn=True)
    for a, b, c in zip(exact, dyn, pre):
        assert torch.equal(b, c)             # prequant = dynamic, exactly
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) / scale < 0.15
        assert float((a - b).abs().mean()) / scale < 0.02


def test_static_conv_bit_equal_when_calibrated_on_its_input():
    g = torch.Generator().manual_seed(17)
    x = torch.randn(2, 16, 16, 8, generator=g)
    dyn = tpk.QuantConv2p(8, 12, (3, 3))
    init_weights(dyn, seed=2)
    with tq.recording(dyn) as accum, torch.no_grad():
        want = dyn(x)
    assert list(accum) == [("calib", "a_max")]
    wq, sw = tq.quantize_weight(dyn.weight.detach())
    sta = tpk.QuantConv2p(8, 12, (3, 3), prequant=True, static_act=True)
    with torch.no_grad():
        sta.kernel_q[..., :8].copy_(wq.permute(0, 2, 3, 1))
        sta.w_scale.copy_(sw)
        sta.bias.copy_(dyn.bias)
        sta.a_scale.copy_(torch.from_numpy(tq.bake_act_scales(
            {}, {("calib", "a_max"): accum[("calib", "a_max")]})[
                "a_scale"]))
        got = sta(x)
    assert torch.equal(got, want)


def _chain(model_fn, gene, steps=5):
    gen = tgen.TeraGenerator(
        DiffusionSampler(spaced_schedule("linear", 1000, f"ddim{steps}"),
                         SamplerConfig(patch_size=32, gn_sz=2)),
        model_fn, tgen.GeneratorConfig(**GKW), device="cpu")
    return gen, gen.run(gene, row0=1, col0=1, grid_w=16, block_major=True,
                        progress=False)


def _chain_gates(a, b):
    d = np.abs(a - b)
    assert np.isfinite(b).all()
    assert d.mean() < CHAIN_MEAN, d.mean()
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > CHAIN_CORR
    assert abs(a.mean() - b.mean()) < CHAIN_SHIFT
    assert abs(a.std() - b.std()) / a.std() < CHAIN_STD


def test_int8_chains_quality():
    """tests/test_quant.py's chain gates: the dynamic int8 chain and the
    int8_static chain calibrated by calibrate_generator, against the exact
    chain, 2x2 tiles x 5 DDIM steps."""
    conf = TUNetConfig(**MKW)
    tree = tpk.pack_unet_params(export_params(init_weights(
        conf.make_model(), 9)), conf)
    qtree = tq.prequantize_params(tree, attn=True)
    gene = gene_grid(tgen.GeneratorConfig(**GKW))

    def fn(m):
        return lambda xp, tm, rp, p1, p2: m(xp, tm, rp, p1, p2,
                                            decode_original=False)

    def model(tr, **kw):
        return load_jax_params(tpk.make_packed_model(conf, **kw), tr).eval()

    _, exact = _chain(fn(model(tree)), gene)
    dyn = model(qtree, quant="int8", prequant=True, quant_attn=True)
    gen, out = _chain(fn(dyn), gene)
    _chain_gates(exact, out)
    stree = tq.calibrate_generator(gen, dyn, qtree, gene, steps=5, row0=1,
                                   col0=1, grid_w=16)
    _, static = _chain(fn(model(stree, quant="int8", prequant=True,
                                static_act=True, quant_attn=True)), gene)
    _chain_gates(exact, static)


# --------------------------------------------------------------------- #
# ops/quant_kernel.py: variants, layouts, counters, refusals             #
# --------------------------------------------------------------------- #
def test_variants_padding_and_kernel_constants():
    assert qk.conv_variant(64, 64) == qk.conv_variant(8, 8) == "wgmma"
    assert qk.conv_variant(5, 7) == "mma_sync"
    assert qk.quantize_variant(None) == "dynamic"
    assert qk.quantize_variant(torch.ones(())) == "static"
    assert [qk.round_up(n, 16) for n in (970, 1482, 1994, 2506, 128)] == \
        [976, 1488, 2000, 2512, 128]
    assert qk.round_up(229, 8) == 232
    a = torch.ones(3, 18, dtype=torch.int8)
    assert qk.pad_last(a, 16).shape == (3, 32)
    assert not qk.pad_last(a, 16)[:, 18:].any()
    b = torch.ones(3, 32, dtype=torch.int8)
    assert qk.pad_last(b, 16) is b
    # the widest main-path input cannot overflow the int32 sums
    assert qk.conv_sum_bound(3, 3, qk.round_up(2506, 16)) < qk.MAX_SUM
    assert qk.conv_sum_bound(3, 3, 16_000) > qk.MAX_SUM
    conv = (_build.CSRC / "quant_conv.cu").read_text()
    wgmma = (_build.CSRC / "quant_conv_wgmma.cu").read_text()
    shared = (_build.CSRC / "quant_conv.cuh").read_text()
    quant = (_build.CSRC / "quantize.cu").read_text()
    assert "enum : int { kWgmma = 0, kMmaSync = 1 };" in shared
    assert "kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2" in shared
    assert qk.CONV_VARIANTS == ("wgmma", "mma_sync")
    assert [qk.CONV_OUT_CODES[d] for d in (torch.float32, torch.bfloat16,
                                            torch.int32)] == [0, 1, 2]
    assert f"constexpr int kCiAlign = {qk.CONV_ALIGN};" in conv
    assert "enum : int { kDynamic = 0, kStatic = 1 };" in quant
    assert qk.QUANT_VARIANTS == ("dynamic", "static")
    # no contraction into an FMA: the explicit intrinsics, in both K3
    # variants, on the scale both form as one float32 product
    assert "__fadd_rn(__fmul_rn(__int2float_rn(a), sa), ba)" in conv
    assert "sw ? __fmul_rn(sxv, sw[n]) : 0.f" in conv
    assert "__fadd_rn(__fmul_rn(__int2float_rn(v), s), b)" in wgmma
    # x / s in IEEE division, rounded half to even (__float2int_rn)
    assert "const float q = __fdiv_rn(x, s);" in quant
    assert "min(max(__float2int_rn(q), -127), 127)" in quant
    assert "const float d = __fdiv_rn(__uint_as_float(m), 127.f);" in quant
    # a NaN stays NaN in the abs-max and the scale, and quantizes to 0
    assert "isnan(d) ? d : fmaxf(d, 1e-8f)" in quant
    assert "return isnan(q) ? 0 :" in quant
    assert "__float_as_uint(v) & 0x7fffffffu" in quant
    for name, argtypes in (("tmt_quant_conv", 21), ("tmt_quantize", 13)):
        assert len(_build.SIGNATURES[name]) == argtypes
        assert f'extern "C" int {name}(' in conv + quant
    assert "tmt_absmax" not in _build.SIGNATURES


def test_plain_conv_is_exact_where_f32_is_not():
    """127^2 * 9 * 128 passes 2^24: the plain K3 is exact in int32."""
    xq = torch.full((1, 3, 3, 128), 127, dtype=torch.int8)
    xq[0, 1, 1, 0] = 126
    wq = torch.full((8, 3, 3, 128), 127, dtype=torch.int8)
    acc = qk.quant_conv_plain(xq, wq, out_dtype=torch.int32)
    assert int(acc[0, 1, 1, 0]) == 127 * 127 * 9 * 128 - 127
    f32 = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).float(),
                                     wq.permute(0, 3, 1, 2).float(),
                                     padding=1)
    assert int(f32[0, 0, 1, 1]) != int(acc[0, 1, 1, 0])


def test_counters_count_every_launch_across_threads():
    qk.reset_launches()
    threads = [threading.Thread(target=lambda: [
        _build.count_launch(c, v) for _ in range(1000)
        for c, v in ((qk.k3, "wgmma"), (qk.k4, "static"))])
        for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert (qk.k3.launches, qk.k4.launches) == (8000, 8000)
    assert qk.k3.launches_by_variant == {"wgmma": 8000, "mma_sync": 0}
    assert qk.k4.launches_by_variant == {"dynamic": 0, "static": 8000}
    qk.reset_launches()
    assert qk.k3.launches == qk.k4.launches_by_variant["static"] == 0


def test_cpu_takes_the_plain_versions_and_nothing_else_runs():
    """CPU tensors run the plain versions and count no launch; a tensor
    on another device (meta here) raises rather than falling back."""
    qk.reset_launches()
    x = torch.randn(4, 8, 8, 24)
    xq, s, amax = qk.quantize(x)
    qk.quant_conv(xq, torch.zeros(8, 3, 3, 32, dtype=torch.int8),
                  torch.ones(8), x_scale=s)
    assert qk.k3.launches == qk.k4.launches == 0
    with pytest.raises(RuntimeError, match="no path"):
        qk.quantize(x.to("meta"))
    with pytest.raises(RuntimeError, match="no path"):
        qk.quant_conv(xq.to("meta"), torch.zeros(8, 3, 3, 32,
                                                 dtype=torch.int8,
                                                 device="meta"))


def test_int8_refuses_autograd():
    x = torch.randn(2, 8, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        qk.quantize(x)
    conv = tpk.QuantConv2p(16, 8, (3, 3))
    init_weights(conv)
    with pytest.raises(RuntimeError, match="inference-only"):
        conv(x.detach())                       # the bias requires grad
    with torch.no_grad():
        assert conv(x).shape == (2, 8, 8, 8)
    with torch.inference_mode():
        assert conv(x).shape == (2, 8, 8, 8)


# --------------------------------------------------------------------- #
# cli.generate --quant                                                   #
# --------------------------------------------------------------------- #
def test_cli_quant_args_model_and_refusal():
    args = tcli.parse_args(["--synthetic"])
    assert (args.quant, args.no_quant_attn) == ("", False)
    args = tcli.parse_args(["--synthetic", "--quant", "int8_static",
                            "--no_quant_attn"])
    assert (args.quant, args.no_quant_attn) == ("int8_static", True)
    with pytest.raises(SystemExit):
        tcli.parse_args(["--quant", "int4"])
    with pytest.raises(SystemExit, match="requires the packed model"):
        tcli.build(tcli.parse_args(["--synthetic", "--quant", "int8",
                                    "--no_packed", "--device", "cpu"]))
    conf = TUNetConfig(**MKW, use_zero_module=False)
    for quant_attn in (True, False):
        m = tcli.make_model(conf, seed=3, quant="int8", quant_attn=quant_attn)
        assert isinstance(m.enc_1_res.in_conv, tpk.QuantConv2p)
        assert m.enc_1_res.in_conv.prequant
        assert isinstance(m.mid_attn.adaLN, tq.QuantDense) == quant_attn
    exact = tcli.make_model(conf, seed=3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((9, 32, 32, 2), np.float32))
    rna = torch.from_numpy(rng.integers(0, 3, (9, 2, 2, 24)).astype(
        np.float32))
    with torch.no_grad():
        a, _ = exact(x, torch.tensor([700]), rna, 3, 3,
                     decode_original=False)
        b, _ = m(x, torch.tensor([700]), rna, 3, 3, decode_original=False)
    scale = float(a.abs().max())
    assert float((a - b).abs().max()) / scale < 0.15
    assert float((a - b).abs().mean()) / scale < 0.02


def test_cli_calibrate_static_swaps_in_the_static_model(capsys):
    """``--quant int8_static``'s step: one dynamic chain over the grid's
    first 2x2 block (of a 3x2 grid) records the abs-maxes; the static
    model that comes back holds them as a_scale buffers, its generator
    runs, and its chain stays within the chain gates of the exact one."""
    conf = TUNetConfig(**MKW)
    gconf = tgen.GeneratorConfig(**GKW)
    gene = gene_grid(gconf, rows=3, cols=2)
    model = tcli.make_model(conf, seed=9, quant="int8")
    sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                               SamplerConfig(patch_size=32, gn_sz=2))

    def model_fn(m):
        return lambda xp, tm, rp, p1, p2: m(xp, tm, rp, p1, p2,
                                            decode_original=False)

    gen = tgen.TeraGenerator(sampler, model_fn(model), gconf, device="cpu")
    args = tcli.parse_args(["--synthetic", "--hnm", "3", "--wnm", "2",
                            "--tot_epoch", "3", "--quant", "int8_static",
                            "--device", "cpu"])
    sgen, static = tcli.calibrate_static(args, gen, model, gene, (1, 1),
                                         model_fn)
    assert "on a 2x2 block" in capsys.readouterr().out
    assert static.enc_1_res.in_conv.static_act
    scales = [float(m.a_scale) for m in static.modules()
              if isinstance(m, tq.QuantModule)]
    assert len(scales) == 53 + 28 and min(scales) > 1e-8
    run = dict(row0=1, col0=1, grid_w=16, block_major=True, progress=False)
    out = sgen.run(gene, **run)
    exact = tgen.TeraGenerator(sampler, model_fn(tcli.make_model(
        conf, seed=9)), gconf, device="cpu").run(gene, **run)
    _chain_gates(exact, out)


def test_int8_runs_on_every_generation_path():
    """The prequantized int8 model behind the CLI's three generation
    paths (in memory block-major, ``--tile_major``, ``--stream`` in 2x2
    windows over a 3x3 grid), each within the chain gates of the exact
    model's chain on the same path."""
    from tera_mind_tpu_torch.parallel import streaming as tstream
    conf = TUNetConfig(**MKW)
    gconf = tgen.GeneratorConfig(**GKW)
    gene = gene_grid(gconf, rows=3, cols=3)
    sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                               SamplerConfig(patch_size=32, gn_sz=2))
    run = dict(row0=1, col0=1, grid_w=16, progress=False)

    def paths(model):
        gen = tgen.TeraGenerator(
            sampler, lambda xp, tm, rp, p1, p2: model(
                xp, tm, rp, p1, p2, decode_original=False), gconf,
            device="cpu")
        stream = tstream.StreamingGenerator(gen, tstream.StreamConfig(
            block_rows=2, block_cols=2, progress=False, block_major=True))
        return {"block_major": gen.run(gene, block_major=True, **run),
                "tile_major": gen.run(gene, block_major=False, **run),
                "stream": stream.run(3, 3, gene, row0=1, col0=1,
                                     grid_w=16).read.float().numpy()}

    qk.reset_launches()
    exact = paths(tcli.make_model(conf, seed=9))
    int8 = paths(tcli.make_model(conf, seed=9, quant="int8"))
    for path in exact:
        assert int8[path].shape == exact[path].shape == (192, 192, 4)
        _chain_gates(exact[path], int8[path])
    assert qk.k3.launches == 0          # the CPU took the plain versions

"""The port's z-packed model against the JAX package's, on the CPU in f32.

``ops/zpack`` (parameter-time numpy functions exactly, tensor functions
exactly), ``GroupedRMSNorm``, ``PackedResBlock``, the DiT block on packed
tokens and ``PackedTeraUNet`` with ``from_5d`` and ``packed_attn`` both
ways, held against ``tera_mind_tpu.models.unet_packed`` on the same numpy
inputs and seeded flax trees; the packed model against the port's own 5D
``TeraUNet`` through ``export_params`` -> ``pack_unet_params``; plus the
truncated lecun-normal init and the kernels' autograd guard.  Tolerances
are the port's f32 reassociation levels (test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_models import GOLDEN_KW, close, randn, seeded_params, t

from tera_mind_tpu.models import attention as jattn
from tera_mind_tpu.models import unet_packed as jpk
from tera_mind_tpu.models.unet import TeraUNetConfig as JUNetConfig
from tera_mind_tpu.ops import zpack as jz
from tera_mind_tpu_torch.convert import export_params, load_jax_params
from tera_mind_tpu_torch.models import attention as tattn
from tera_mind_tpu_torch.models import nn as tnn
from tera_mind_tpu_torch.models import unet_packed as tpk
from tera_mind_tpu_torch.models.unet import TeraUNetConfig as TUNetConfig
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import zpack as tz

ATOL = 2e-5   # block level, O(1) activations


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
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------- #
# ops/zpack                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kz,segs", [(3, None), (1, None), (3, (5, 3, 4)),
                                     (1, (2, 6))])
def test_zpack_numpy_functions_equal_jax(kz, segs):
    rng = np.random.default_rng(0)
    ci = sum(segs) if segs else 7
    w3 = randn(rng, kz, 3, 3, ci, 6)
    b, p = randn(rng, 6), randn(rng, ci)
    for z in (2, 3):
        np.testing.assert_array_equal(tz.pack_conv3d_kernel(w3, z, segs),
                                      jz.pack_conv3d_kernel(w3, z, segs))
        np.testing.assert_array_equal(tz.pack_conv3d_bias(b, z),
                                      jz.pack_conv3d_bias(b, z))
        np.testing.assert_array_equal(tz.pack_channel_param(p, z, segs),
                                      jz.pack_channel_param(p, z, segs))
        if segs:
            np.testing.assert_array_equal(tz.seg_perm(z, segs),
                                          jz.seg_perm(z, segs))


@pytest.mark.parametrize("kz,segs", [(3, None), (3, (5, 3, 4)), (1, (2, 6))])
def test_tensor_kernel_pack_equals_numpy_and_jax(kz, segs):
    """The from_5d model's per-call kernel build, in the port's
    (out, in, ...) layout, equals the numpy and the jnp versions."""
    ci = sum(segs) if segs else 7
    w3 = randn(np.random.default_rng(1), kz, 3, 3, ci, 6)  # flax layout
    got = tz.pack_conv3d_kernel_t(t(w3.transpose(4, 3, 0, 1, 2).copy()), 2,
                                  segs)
    want = jz.pack_conv3d_kernel(w3, 2, segs).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(jz.pack_conv3d_kernel_jnp(jnp.asarray(w3), 2,
                                                   segs)).transpose(3, 2, 0, 1))


def test_tensor_pack_functions_equal_jax():
    rng = np.random.default_rng(2)
    x5 = randn(rng, 3, 2, 4, 6, 5)
    xp = randn(rng, 3, 4, 6, 10)
    for name, x in (("pack_features", x5), ("unpack_features", xp),
                    ("pixel_to_packed", xp), ("packed_to_pixel", xp)):
        got = getattr(tz, name)(t(x), 2)
        want = np.asarray(getattr(jz, name)(jnp.asarray(x), 2))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(
        tz.unpack_features(tz.pack_features(t(x5), 2), 2).numpy(), x5)
    np.testing.assert_array_equal(
        tz.packed_to_pixel(tz.pixel_to_packed(t(xp), 2), 2).numpy(), xp)


# --------------------------------------------------------------------- #
# GroupedRMSNorm                                                         #
# --------------------------------------------------------------------- #
NORM_CASES = [((12,), False), ((5, 3), False), ((8, 16, 6), False),
              ((12,), True), ((5, 3), True)]


def norm_case(segs, from_5d, seed=3):
    rng = np.random.default_rng(seed)
    z = 2
    x = randn(rng, 3, 4, 5, z * sum(segs), scale=3.0)
    w = 1.0 + 0.2 * randn(rng, sum(segs) * (1 if from_5d else z))
    jm = jpk.GroupedRMSNorm(z=z, segments=segs, from_5d=from_5d)
    p = {"params": {"weight": w}}
    tm = load_jax_params(tpk.GroupedRMSNorm(z, segs, from_5d=from_5d), p)
    return x, p, jm, tm


@pytest.mark.parametrize("segs,from_5d", NORM_CASES)
def test_grouped_rmsnorm_f32_matches_jax(segs, from_5d):
    x, p, jm, tm = norm_case(segs, from_5d)
    close(tm(t(x)), jm.apply(p, jnp.asarray(x)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("segs,from_5d", NORM_CASES)
def test_grouped_rmsnorm_bf16_matches_jax(segs, from_5d):
    """Both round after each of the two multiplies; the f32 statistics
    are summed in other orders, so at most 1 bf16 spacing apart."""
    x, p, jm, tm = norm_case(segs, from_5d, seed=4)
    xb = x.astype(ml_dtypes.bfloat16)
    want = np.asarray(jm.apply(p, jnp.asarray(xb))).astype(np.float32)
    got = tm.to(torch.bfloat16)(t(xb.astype(np.float32)).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.detach().float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ulp).all()


# --------------------------------------------------------------------- #
# PackedResBlock and the DiT block on packed tokens                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("segs,cout,up,down,from_5d", [
    ((5, 3), 8, False, False, False), ((5, 3), 6, False, False, False),
    ((6,), 6, True, False, False), ((6,), 6, False, True, False),
    ((4, 3, 5), 7, False, False, True), ((6,), 6, True, False, True)])
def test_packed_resblock_matches_jax(segs, cout, up, down, from_5d):
    rng = np.random.default_rng(5)
    z = 2
    x, emb = randn(rng, 3, 8, 8, z * sum(segs)), randn(rng, 3, 32)
    jm = jpk.PackedResBlock(out_channels=cout, z=z,
                            in_segments=segs if len(segs) > 1 else None,
                            up=up, down=down, dropout=0.0, from_5d=from_5d)
    p = seeded_params(jm, x, emb, seed=6)
    tm = load_jax_params(tpk.PackedResBlock(
        sum(segs), cout, z, 32, in_segments=segs, up=up, down=down,
        from_5d=from_5d), p)
    close(tm(t(x), t(emb)), jm.apply(p, x, emb))


def former_resblock(blk, x, emb):
    """PackedResBlock.forward as it ran before the norm took its consumer:
    the norm alone, then the eager SiLU, and the modulate by the
    repeated (B, C) halves and the SiLU after out_norm."""
    import torch.nn.functional as F
    dt, z = blk.in_conv.dtype, blk.z
    h = F.silu(blk.in_norm(x.to(dt)))
    if blk.up:
        h, x = tpk._up2(h), tpk._up2(x)
    elif blk.down:
        h, x = tpk._down2(h), tpk._down2(x)
    h = blk.out_norm(blk.in_conv(h))
    if emb is not None:
        emb_out = blk.emb_proj(F.silu(emb.to(dt))).to(h.dtype)
        scale, shift = emb_out.chunk(2, dim=-1)
        h = (h * (1.0 + scale.repeat(1, z)[:, None, None, :])
             + shift.repeat(1, z)[:, None, None, :])
    h = blk.out_conv(F.silu(h))
    if hasattr(blk, "skip_conv"):
        x = blk.skip_conv(x)
    return (x + h).to(dt)


@pytest.mark.parametrize("segs,cout,up,from_5d,with_emb", [
    ((5, 3), 8, False, False, True), ((6,), 6, True, False, True),
    ((4, 3, 5), 7, False, True, True), ((5, 3), 8, False, False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_resblock_fused_norms_are_the_former_sequence(
        segs, cout, up, from_5d, with_emb, dtype):
    """The ResBlock's norms with their consumers (in_norm's SiLU,
    out_norm's modulate and SiLU, or the SiLU alone without an embedding)
    give the former eager sequence's output bit for bit on the CPU, and
    under autograd the same gradients of every parameter."""
    rng = np.random.default_rng(11)
    z = 2
    blk = tpk.PackedResBlock(sum(segs), cout, z, 32 if with_emb else None,
                             in_segments=segs, up=up, from_5d=from_5d)
    with torch.no_grad():
        for prm in blk.parameters():   # the module allocates, unset
            prm.copy_(t(1.0 * (prm.dim() == 1 and prm.numel() % z == 0)
                        + 0.2 * randn(rng, *prm.shape)))
    blk = blk.to(dtype)
    x = t(randn(rng, 3, 8, 8, z * sum(segs))).to(dtype)
    emb = t(randn(rng, 3, 32)).to(dtype) if with_emb else None
    with torch.no_grad():
        assert torch.equal(blk(x, emb), former_resblock(blk, x, emb))
    grads = []
    for fn in (blk, lambda a, b: former_resblock(blk, a, b)):
        blk.zero_grad()
        fn(x, emb).float().square().sum().backward()
        grads.append([p.grad.clone() for p in blk.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


FOLD_CASES = [((5, 3), 8, False, False, False), ((6,), 6, False, False, False),
              ((6,), 6, True, False, False), ((6,), 6, False, True, False),
              ((4, 3, 5), 7, False, False, True), ((6,), 6, True, False, True)]


def resblock_case(segs, cout, up, down, from_5d, dtype=jnp.float32):
    """Inputs, the JAX PackedResBlock (``compute_dtype``) and its seeded
    params, and the port's block loaded from them, folded on the CPU."""
    rng = np.random.default_rng(15)
    z = 2
    x, emb = randn(rng, 3, 8, 8, z * sum(segs)), randn(rng, 3, 32)
    jm = jpk.PackedResBlock(out_channels=cout, z=z,
                            in_segments=segs if len(segs) > 1 else None,
                            up=up, down=down, dropout=0.0, from_5d=from_5d,
                            compute_dtype=dtype)
    p = seeded_params(jm, x, emb, seed=16)
    p = jax.tree.map(lambda a: a + 0.1 * (a.ndim == 1), p)   # biases on
    tm = load_jax_params(tpk.PackedResBlock(
        sum(segs), cout, z, 32, in_segments=segs, up=up, down=down,
        from_5d=from_5d), p)
    tm.fold = True
    return x, emb, jm, p, tm


@pytest.mark.parametrize("segs,cout,up,down,from_5d", FOLD_CASES)
def test_folded_resblock_matches_jax_f32(segs, cout, up, down, from_5d):
    """The folded route (in_conv's bias in out_norm's prologue, out_conv's
    and skip_conv's biases with the residual sum in K6; the kernels' plain
    versions on the CPU) against the JAX PackedResBlock: float32 within
    1e-5 of the output's max, with and without a skip conv, up and
    down, both parameter layouts."""
    x, emb, jm, p, tm = resblock_case(segs, cout, up, down, from_5d)
    with torch.no_grad():
        assert tm.folds(t(x), t(emb))
        got = tm(t(x), t(emb))
    want = np.asarray(jm.apply(p, x, emb))
    assert hasattr(tm, "skip_conv") == (sum(segs) != cout)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("segs,cout,up,down,from_5d", FOLD_CASES)
def test_folded_resblock_matches_jax_bf16(segs, cout, up, down, from_5d):
    """The folded route in bf16 against the JAX PackedResBlock in bf16:
    the two round after different ops (XLA adds the conv bias in the
    conv's float32 output), so they agree to bf16 noise, within the bf16
    model's bounds (test_torch_models.py's test_teraunet_bf16_matches_jax_
    bf16: mean 2e-2, max 0.2) scaled to the output's max; and as close
    as the eager route is."""
    x, emb, jm, p, tm = resblock_case(segs, cout, up, down, from_5d,
                                      jnp.bfloat16)
    tm = tm.to(torch.bfloat16)
    xb, eb = t(x).bfloat16(), t(emb).bfloat16()
    want = np.asarray(jm.apply(p, jnp.asarray(xb.float().numpy(),
                                              jnp.bfloat16),
                               jnp.asarray(eb.float().numpy(),
                                           jnp.bfloat16))).astype(np.float32)
    diffs = []
    for fold in (True, False):
        tm.fold = fold
        with torch.no_grad():
            got = tm(xb, eb)
        assert got.dtype == torch.bfloat16
        diffs.append(np.abs(got.float().numpy() - want) / np.abs(want).max())
    for d in diffs:
        assert d.mean() <= 2e-2 and d.max() <= 0.2, (d.mean(), d.max())
    assert diffs[0].max() <= 2 * diffs[1].max() + 2 ** -7


def card_eager_resblock(blk, x, emb):
    """The ResBlock as it runs unfolded on the card: each conv's product
    without its bias, then PyTorch's broadcast ``add_`` of the bias
    (``at::cudnn_convolution`` then ``output.add_(bias)``), the norms
    with their epilogues, then ``(x + h).to(dt)``."""
    import torch.nn.functional as F

    def conv(c, a):
        y = c.product(a)
        y.permute(0, 3, 1, 2).add_(c.packed_bias().reshape(1, -1, 1, 1))
        return y
    dt = blk.in_conv.dtype
    h = blk.in_norm(x.to(dt), act="silu")
    if blk.up:
        h, x = tpk._up2(h), tpk._up2(x)
    elif blk.down:
        h, x = tpk._down2(h), tpk._down2(x)
    h = conv(blk.in_conv, h)
    scale, shift = blk.emb_proj(F.silu(emb.to(dt))).to(h.dtype).chunk(2, -1)
    h = conv(blk.out_conv, blk.out_norm(h, act="modulate_silu",
                                        scale=scale, shift=shift))
    if hasattr(blk, "skip_conv"):
        x = conv(blk.skip_conv, x)
    return (x + h).to(dt)


@pytest.mark.parametrize("segs,cout,up,down,from_5d", FOLD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_resblock_is_the_card_eager_sequence(segs, cout, up, down,
                                                    from_5d, dtype):
    """The folded route gives the bits of the eager sequence as it runs on
    the card (the bias-free product, then the bias adds and the sum),
    bf16 and float32: the fold moves no chain there.  Where autograd
    records, the block does not fold; with ``fold = False`` never."""
    x, emb, _, _, tm = resblock_case(segs, cout, up, down, from_5d)
    tm = tm.to(dtype)
    xt, et = t(x).to(dtype), t(emb).to(dtype)
    with torch.no_grad():
        assert torch.equal(tm(xt, et), card_eager_resblock(tm, xt, et))
    assert not tm.folds(xt, et)          # grad mode on, parameters
    with torch.no_grad():
        assert tm.folds(xt, et)
        tm.fold = None                   # the default: on the card only
        assert not tm.folds(xt, et) and tm.folds(xt.to("meta"), et)
        tm.fold = False
        assert not tm.folds(xt.to("meta"), et)


def test_int8_resblock_does_not_fold():
    """int8 convs keep their biases in K3's dequantize: an int8 block
    never folds, nor does a block whose identity skip has another dtype
    than its convs."""
    blk = tpk.PackedResBlock(6, 6, 2, 32, quant="int8")
    blk.fold = True
    with torch.no_grad():
        assert not blk.plain_convs()
        assert not blk.folds(torch.zeros(1, 4, 4, 12))
    blk = tpk.PackedResBlock(6, 6, 2, 32).to(torch.bfloat16)
    blk.fold = True
    with torch.no_grad():
        assert blk.folds(torch.zeros(1, 4, 4, 12, dtype=torch.bfloat16))
        assert not blk.folds(torch.zeros(1, 4, 4, 12))


def test_window_fold_hwz_matches_jax():
    x = randn(np.random.default_rng(7), 2, 3, 2 * 8 * 8, 5)
    folded = tattn._window_fold(t(x), 2, 2, "hwz")
    np.testing.assert_array_equal(
        folded.numpy(), np.asarray(jattn._window_fold(x, 2, 2, "hwz")))
    np.testing.assert_array_equal(
        tattn._window_unfold(folded, 2, 2, 3, "hwz").numpy(), x)


def test_dit_block_packed_tokens_matches_jax():
    rng = np.random.default_rng(8)
    x, cond = randn(rng, 2, 8, 8, 2 * 16), randn(rng, 2, 8, 8, 2 * 6)
    jm = jattn.DiTBlock(hidden_size=16, n_win=2, packed_tokens=True)
    p = seeded_params(jm, x, cond, 2, seed=9)
    tm = load_jax_params(tattn.DiTBlock(16, 6, n_win=2, packed_tokens=True),
                         p)
    assert tm.attn.token_order == "hwz"
    close(tm(t(x), t(cond), 2), jm.apply(p, x, cond, 2))


# --------------------------------------------------------------------- #
# PackedTeraUNet                                                         #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def packed_case():
    """Inputs, a seeded 5D flax tree, JAX's packed tree of it and the JAX
    packed model's outputs (both decoders, 3x3 patch grid): from packed
    params without packed_attn, and from the 5D params with it."""
    rng = np.random.default_rng(20)
    x = randn(rng, 4 * 9, 32, 32, 4)
    rna = ((rng.random((36, 2, 2, 64)) < 0.2) * 3).astype(np.float32)
    ts = np.array([500, 20, 999, 0], np.int32)
    jconf = JUNetConfig(**GOLDEN_KW, dropout=0.0)
    p5 = seeded_params(jconf.make_model(), x[:4], ts[:1], rna[:4], 2, 2,
                       seed=21)
    p5 = jax.tree.map(lambda a: np.asarray(a, np.float32), p5)
    pp = jpk.pack_unet_params(p5, jconf)
    want = {}
    for packed_attn, from_5d, p in ((False, False, pp), (True, True, p5)):
        jm = jpk.PackedTeraUNet(jconf, from_5d=from_5d,
                                packed_attn=packed_attn)
        col, orig = jax.jit(lambda q, m=jm: m.apply(q, x, ts, rna, 3, 3))(p)
        want[packed_attn] = (np.asarray(col), np.asarray(orig))
    return x, rna, ts, p5, pp, want


def test_pack_unet_params_equals_jax(packed_case):
    _, _, _, p5, pp, _ = packed_case
    assert_trees_equal(
        tpk.pack_unet_params(p5, TUNetConfig(**GOLDEN_KW)), pp)


@pytest.mark.parametrize("from_5d", [False, True])
@pytest.mark.parametrize("packed_attn", [False, True])
def test_packed_teraunet_matches_jax(packed_case, from_5d, packed_attn):
    """Against the JAX packed model run with the same ``packed_attn``
    (its ``from_5d`` setting only changes where the kernels are packed,
    not the arithmetic)."""
    x, rna, ts, p5, pp, want = packed_case
    model = tpk.make_packed_model(TUNetConfig(**GOLDEN_KW), from_5d=from_5d,
                                  packed_attn=packed_attn)
    load_jax_params(model, p5 if from_5d else pp)
    with torch.no_grad():
        col, orig = model(t(x), t(ts).long(), t(rna), 3, 3)
    assert col.dtype == torch.float32 and col.shape == want[packed_attn][0].shape
    close(col, want[packed_attn][0], atol=1e-4, rtol=1e-4)
    close(orig, want[packed_attn][1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("from_5d", [False, True])
def test_folded_packed_teraunet_matches_jax(packed_case, from_5d):
    """The whole packed model with every ResBlock folded (K5's bias
    prologue, K6; the plain versions on the CPU) against the JAX packed
    model, both decoders: float32 within 1e-5 of the output's max.  The
    fold adds no parameter: the same trees load (``convert``
    unchanged)."""
    x, rna, ts, p5, pp, want = packed_case
    model = tpk.make_packed_model(TUNetConfig(**GOLDEN_KW), from_5d=from_5d)
    load_jax_params(model, p5 if from_5d else pp)
    blocks = [m for m in model.modules()
              if isinstance(m, tpk.PackedResBlock)]
    for m in blocks:
        m.fold = True
    from tera_mind_tpu_torch.ops import residual_kernel as k6
    calls = []
    real = k6.residual_plain
    k6.residual_plain = lambda *a: calls.append(1) or real(*a)
    try:
        with torch.no_grad():
            col, orig = model(t(x), t(ts).long(), t(rna), 3, 3)
    finally:
        k6.residual_plain = real
    assert len(calls) == 2 * len(blocks) - sum(
        name.startswith(("enc_", "mid_")) for name, m in
        model.named_children() if isinstance(m, tpk.PackedResBlock))
    for got, ref in zip((col, orig), want[False]):
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_packed_teraunet_matches_the_ports_5d_model(packed_case):
    """The port's packed model on ``pack_unet_params(export_params(5D))``
    reproduces the port's 5D model (a re-parameterization, equal up to
    f32 reassociation), collage decoder only."""
    x, rna, ts, p5, _, _ = packed_case
    conf = TUNetConfig(**GOLDEN_KW)
    model5 = load_jax_params(conf.make_model(), p5)
    packed = load_jax_params(
        tpk.make_packed_model(conf),
        tpk.pack_unet_params(export_params(model5), conf))
    with torch.no_grad():
        want, _ = model5(t(x), t(ts).long(), t(rna), 3, 3,
                         decode_original=False)
        got, none = packed(t(x), t(ts).long(), t(rna), 3, 3,
                           decode_original=False)
    assert none is None
    close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
def test_export_params_is_the_inverse_of_load(packed_case, packed):
    _, _, _, p5, pp, _ = packed_case
    conf = TUNetConfig(**GOLDEN_KW)
    tree = pp if packed else p5
    model = tpk.make_packed_model(conf) if packed else conf.make_model()
    assert_trees_equal(export_params(load_jax_params(model, tree)), tree)


# --------------------------------------------------------------------- #
# init and the kernels' autograd guard                                   #
# --------------------------------------------------------------------- #
def test_init_weights_is_truncated_lecun_normal():
    """flax's lecun_normal: a standard normal cut to [-2, 2], scaled to
    std sqrt(1/fan_in) (variance_scaling 'truncated_normal')."""
    model = torch.nn.Sequential(tnn.Conv3d(64, 96, (3, 3, 3)),
                                tnn.Dense(40, 30), tnn.Conv2d(16, 8, (3, 3)),
                                tnn.Conv3d(8, 8, (1, 1, 1), zero_init=True),
                                tnn.RMSNorm(6))
    tnn.init_weights(model, seed=1).requires_grad_(False)
    for mod in list(model)[:3]:
        w = mod.weight
        std = (1.0 / w[0].numel()) ** 0.5
        assert float(w.abs().max()) <= 2.0 * std / tnn.TRUNC_STD
        assert float(w.abs().max()) > 1.8 * std / tnn.TRUNC_STD
        assert float(mod.bias.abs().max()) == 0.0
    big = model[0].weight                          # 165,888 draws
    assert abs(float(big.std()) / (1.0 / big[0].numel()) ** 0.5 - 1) < 0.02
    assert float(model[3].weight.abs().max()) == 0.0
    assert torch.equal(model[4].weight, torch.ones(6))
    again = tnn.init_weights(torch.nn.Sequential(
        tnn.Conv3d(64, 96, (3, 3, 3))), seed=1)
    assert torch.equal(again[0].weight, big)


def test_autograd_guard_predicate():
    a = torch.ones(3)
    p = torch.nn.Parameter(torch.ones(3))
    assert not _build.autograd_required(a, a)
    assert _build.autograd_required(a, p)
    with torch.no_grad():
        assert not _build.autograd_required(a, p)
    with torch.inference_mode():
        assert not _build.autograd_required(a, p)
    with pytest.raises(RuntimeError, match="K1b and K2b"):
        _build.refuse_autograd("rmsnorm", a, p)
    _build.refuse_autograd("rmsnorm", a, a)

"""The port's model modules against the JAX package's, on the CPU in f32.

Flax param trees come from ``jax.eval_shape(model.init)`` with every leaf
filled by seeded numpy values (init-like scales, non-zero everywhere, also
the zero-initialised ``out_conv`` s, so residual paths and norms are
exercised), then carried into the port with ``load_jax_params``.  Both
sides get the same numpy inputs.  Tolerances are f32 reassociation
levels: different conv/matmul algorithms sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tera_mind_tpu.models import attention as jattn
from tera_mind_tpu.models import blocks as jblocks
from tera_mind_tpu.models import nn as jnn
from tera_mind_tpu.models import rna as jrna
from tera_mind_tpu.models.unet import TeraUNetConfig as JUNetConfig
from tera_mind_tpu_torch.convert import load_jax_params
from tera_mind_tpu_torch.models import attention as tattn
from tera_mind_tpu_torch.models import blocks as tblocks
from tera_mind_tpu_torch.models import nn as tnn
from tera_mind_tpu_torch.models import rna as trna
from tera_mind_tpu_torch.models.unet import TeraUNetConfig as TUNetConfig

ATOL = 2e-5   # block level, O(1) activations


def seeded_params(module, *args, seed=0, **kw):
    """Flax param tree of ``module`` with seeded non-zero values."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(s.shape[:-1]))
        if name == "weight":                      # RMSNorm
            return 1.0 + 0.2 * z
        return 0.1 * z                            # biases

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol=ATOL, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def test_timestep_embedding_matches_jax():
    ts = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (8, 9, 64):
        close(tnn.timestep_embedding(t(ts).long(), dim),
              jnn.timestep_embedding(jnp.asarray(ts), dim), atol=1e-5)


def test_up_down_sample_match_jax():
    x = randn(np.random.default_rng(0), 2, 2, 4, 6, 3)
    np.testing.assert_array_equal(tnn.upsample_2x(t(x)).numpy(),
                                  np.asarray(jnn.upsample_2x(x)))
    close(tnn.downsample_2x(t(x)), jnn.downsample_2x(x), atol=1e-6)


def test_rmsnorm_module_matches_jax():
    x = randn(np.random.default_rng(1), 3, 2, 4, 4, 40, scale=3.0)
    p = seeded_params(jnn.RMSNorm(), x, seed=2)
    m = load_jax_params(tnn.RMSNorm(40), p)
    close(m(t(x)), jnn.RMSNorm().apply(p, x), atol=1e-6)


def test_time_embed_and_mlp_match_jax():
    rng = np.random.default_rng(3)
    e = randn(rng, 5, 16)
    jm = jnn.TimeEmbed(24)
    p = seeded_params(jm, e, seed=4)
    close(load_jax_params(tnn.TimeEmbed(16, 24), p)(t(e)), jm.apply(p, e))
    x = randn(rng, 2, 7, 12)
    jm = jnn.Mlp(48)
    p = seeded_params(jm, x, seed=5)
    close(load_jax_params(tnn.Mlp(12, 48), p)(t(x)), jm.apply(p, x))


@pytest.mark.parametrize("kernel", [(1, 3, 3), (3, 3, 3), (1, 1, 1)])
def test_conv3d_matches_jax(kernel):
    x = randn(np.random.default_rng(6), 2, 3, 8, 8, 5)
    jm = jnn.conv3d(7, kernel)
    p = seeded_params(jm, x, seed=7)
    close(load_jax_params(tnn.Conv3d(5, 7, kernel), p)(t(x)), jm.apply(p, x))


def test_conv3d_bf16_on_the_cpu_matches_jax_gradients():
    """A bf16 ``Conv3d`` on float32 master weights (training's compute) on
    the CPU: its output and its weight and input gradients against
    ``jax.grad`` of the flax conv at bf16 (XLA sums in float32), within
    2e-2 of each one's max (a few bf16 roundings).  PyTorch's own CPU bf16
    conv3d put the weight gradient 0.4-0.9 of its max away."""
    rng = np.random.default_rng(16)
    x = randn(rng, 8, 2, 64, 64, 96, scale=3.0)
    g = randn(rng, 8, 2, 64, 64, 64)
    jm = jnn.conv3d(64, (3, 3, 3), dtype=jnp.bfloat16)
    p = seeded_params(jm, x, seed=17)

    def f(params, xx):
        return (jm.apply(params, xx).astype(jnp.float32) * g).sum()
    jy = np.asarray(jm.apply(p, x).astype(jnp.float32))
    jdp, jdx = jax.grad(f, argnums=(0, 1))(p, x)
    m = tnn.set_compute_dtype(load_jax_params(tnn.Conv3d(96, 64, (3, 3, 3)),
                                              p), torch.bfloat16,
                              param_dtype=torch.float32)
    xx = t(x).requires_grad_()
    y = m(xx)
    assert y.dtype == torch.bfloat16
    y.float().mul(t(g)).sum().backward()
    dw = np.asarray(jdp["params"]["kernel"]).transpose(4, 3, 0, 1, 2)
    for got, want in ((y.detach().float().numpy(), jy),
                      (m.weight.grad.numpy(), dw),
                      (xx.grad.numpy(), np.asarray(jdx))):
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_window_fold_matches_jax():
    x = randn(np.random.default_rng(8), 2, 3, 2 * 8 * 8, 5)
    folded = tattn._window_fold(t(x), 2, 2)
    np.testing.assert_array_equal(folded.numpy(),
                                  np.asarray(jattn._window_fold(x, 2, 2)))
    back = tattn._window_unfold(folded, 2, 2, 3)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("num_heads,n_win", [(1, 2), (2, 2), (2, None)])
def test_cross_attention_matches_jax(num_heads, n_win):
    rng = np.random.default_rng(9)
    z, s, c = 2, 8, 16
    x, y = randn(rng, 3, z * s * s, c), randn(rng, 3, z * s * s, c)
    jm = jattn.CrossAttention(dim=c, num_heads=num_heads, n_win=n_win,
                              backend="xla")
    p = seeded_params(jm, x, y, z, seed=10)
    tm = load_jax_params(tattn.CrossAttention(c, num_heads, n_win), p)
    close(tm(t(x), t(y), z), jm.apply(p, x, y, z))


@pytest.mark.parametrize("cin,cout,up,down", [
    (12, 12, False, False), (12, 20, False, False),
    (12, 12, True, False), (12, 12, False, True)])
def test_resblock_matches_jax(cin, cout, up, down):
    rng = np.random.default_rng(11)
    x, emb = randn(rng, 3, 2, 8, 8, cin), randn(rng, 3, 32)
    jm = jblocks.ResBlock3D(out_channels=cout, up=up, down=down,
                            dropout=0.0)
    p = seeded_params(jm, x, emb, seed=12)
    tm = load_jax_params(tblocks.ResBlock3D(cin, cout, 32, up=up,
                                            down=down), p)
    close(tm(t(x), t(emb)), jm.apply(p, x, emb))


def test_dit_block_matches_jax():
    rng = np.random.default_rng(13)
    x, cond = randn(rng, 2, 2, 8, 8, 16), randn(rng, 2, 2, 8, 8, 6)
    jm = jattn.DiTBlock(hidden_size=16, n_win=2)
    p = seeded_params(jm, x, cond, seed=14)
    tm = load_jax_params(tattn.DiTBlock(16, 6, n_win=2), p)
    close(tm(t(x), t(cond)), jm.apply(p, x, cond))


def test_gene_gene_block_matches_jax():
    rng = np.random.default_rng(15)
    rna = randn(rng, 3, 4, 2, 2, 9)
    jm = jattn.GeneGeneBlock(hidden_size=16, z_size=4)
    p = seeded_params(jm, rna, seed=16)
    tm = load_jax_params(tattn.GeneGeneBlock(16, 4, 9), p)
    (got, got_attn), (want, want_attn) = (
        tm(t(rna), return_attn=True), jm.apply(p, rna, return_attn=True))
    close(got, want)
    close(got_attn, want_attn, atol=1e-6)


@pytest.mark.parametrize("g,rna_num", [(6, 6), (8, 6), (500, 81)])
def test_rna_grid_from_dense_matches_jax(g, rna_num):
    x = randn(np.random.default_rng(17), 2, 2, 2, 4 * g)
    np.testing.assert_array_equal(
        trna.rna_grid_from_dense(t(x), 4, rna_num).numpy(),
        np.asarray(jrna.rna_grid_from_dense(x, 4, rna_num)))


def test_rna_tower_matches_jax():
    grid = randn(np.random.default_rng(18), 2, 4, 2, 2, 7)
    jm = jrna.RNATower(rna_num=7, z_rna=4, gn_sz=2)
    p = seeded_params(jm, grid, seed=19)
    tm = load_jax_params(trna.RNATower(7, 4, 2), p)
    (tf, tp, _), (jf, jp, _) = tm(t(grid)), jm.apply(p, grid)
    for a, b in zip(tf + tp, list(jf) + list(jp)):
        close(a, b)


# the golden config of tests/test_golden.py, f32
GOLDEN_KW = dict(image_size=32, gn_sz=2, rna_num=16, rna_tpl=(0, 1, 2, 3),
                 in_channels=4, out_channels=4, model_channels=8,
                 embed_channels=32)


@pytest.fixture(scope="module")
def unet_case():
    """Inputs, flax params and the JAX outputs of both decoders on a 3x3
    patch grid (one jit of the JAX model)."""
    rng = np.random.default_rng(20)
    x = randn(rng, 4 * 9, 32, 32, 4)
    rna = ((rng.random((36, 2, 2, 64)) < 0.2) * 3).astype(np.float32)
    ts = np.array([500, 20, 999, 0], np.int32)
    jm = JUNetConfig(**GOLDEN_KW, dropout=0.0).make_model()
    p = seeded_params(jm, x[:4], ts[:1], rna[:4], 2, 2, seed=21)
    col, orig = jax.jit(lambda q: jm.apply(q, x, ts, rna, 3, 3))(p)
    return x, rna, ts, p, np.asarray(col), np.asarray(orig)


@pytest.mark.parametrize("decode_original", [True, False])
def test_teraunet_matches_jax(unet_case, decode_original):
    """The collage prediction does not depend on decode_original, so the
    JAX run with both decoders is the reference for both port modes."""
    x, rna, ts, p, col, orig = unet_case
    model = load_jax_params(TUNetConfig(**GOLDEN_KW).make_model(), p)
    with torch.no_grad():
        got_col, got_orig = model(t(x), t(ts).long(), t(rna), 3, 3,
                                  decode_original=decode_original)
    assert got_col.dtype == torch.float32 and got_col.shape == col.shape
    close(got_col, col, atol=1e-4, rtol=1e-4)
    if decode_original:
        close(got_orig, orig, atol=1e-4, rtol=1e-4)
    else:
        assert got_orig is None


def test_load_jax_params_is_strict():
    jm = jnn.Mlp(8)
    p = seeded_params(jm, np.zeros((2, 4), np.float32))
    with pytest.raises(KeyError):
        load_jax_params(tnn.Mlp(4, 8, 4), {"params": {**p["params"],
                                                      "extra": {"bias": 0}}})
    with pytest.raises(ValueError):
        load_jax_params(tnn.Mlp(4, 9, 4), p)


@pytest.fixture(scope="module")
def unet_bf16_case(unet_case):
    """The JAX model in bf16 on the same inputs and params: its collage
    prediction and the time embedding it computed (captured)."""
    x, rna, ts, p, _, _ = unet_case
    jm = JUNetConfig(**GOLDEN_KW, dropout=0.0,
                     dtype_name="bfloat16").make_model()
    (col, _), state = jax.jit(lambda q: jm.apply(
        q, x, ts, rna, 3, 3, decode_original=False,
        capture_intermediates=lambda mdl, _: mdl.name == "time_embed",
        mutable=["intermediates"]))(p)
    emb = state["intermediates"]["time_embed"]["__call__"][0]
    return np.asarray(col), np.asarray(emb)


def test_teraunet_bf16_matches_jax_bf16(unet_case, unet_bf16_case):
    """The main path's compute dtype: both sides in bf16 with the same
    (bf16-rounded) weights.  The two round after different ops (XLA may
    keep excess precision between fused ops), so they agree only to bf16
    noise: at this config they differ by about as much as JAX bf16 does
    from JAX f32 (mean |d| ~7e-3, max ~5e-2 on outputs up to ~3).  Bounds:
    mean 2e-2, max 0.2."""
    x, rna, ts, p, _, _ = unet_case
    want = unet_bf16_case[0]
    model = load_jax_params(
        TUNetConfig(**GOLDEN_KW, dtype_name="bfloat16").make_model(), p)
    assert model.stem.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got, _ = model(t(x), t(ts).long(), t(rna), 3, 3,
                       decode_original=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = np.abs(got.numpy() - want)
    assert diff.mean() <= 2e-2 and diff.max() <= 0.2, (diff.mean(),
                                                        diff.max())


def test_time_embed_stays_f32_in_bf16_model(unet_case, unet_bf16_case):
    """JAX's TimeEmbed sets no compute dtype, so in the bf16 model it still
    computes in f32 on f32 params: the port's bf16 model keeps its
    time_embed weights in f32 and matches it at f32 tolerance (1e-5 on
    O(1) values; an embedding from bf16-rounded weights, computed in bf16,
    is off by up to ~5e-3 here)."""
    _, _, ts, p, _, _ = unet_case
    model = load_jax_params(
        TUNetConfig(**GOLDEN_KW, dtype_name="bfloat16").make_model(), p)
    assert {w.dtype for w in model.time_embed.parameters()} == \
        {torch.float32}
    with torch.no_grad():
        got = model.time_embed(tnn.timestep_embedding(t(ts).long(), 8))
    assert got.dtype == torch.float32
    close(got, unet_bf16_case[1], atol=1e-5, rtol=1e-5)

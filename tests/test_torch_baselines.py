"""The port's baseline models (patch-dm, sinf), their blocks and
``EquiGroupNorm`` against the JAX package's, on the CPU in float32.

Inputs come from ``np.random.default_rng(seed)``; JAX parameter trees are
seeded non-zero (norm scales near 1, so no zero-init projection hides a
path) and carried into the port with ``convert.load_jax_params``.
Tolerances: blocks 1e-5 of the output's scale (max(1, |out|max)); whole
models 1e-5 of the output's max; one accumulated training step: the loss
within 1e-4 and Adam's first moment (0.1 times the clipped gradient)
within 2e-3 of each leaf's max (a leaf whose gradient is 0 but for
rounding, both sides below 1e-6 of the largest).  Where the JAX package
fails (a baseline
in the packed layout, sinf without ``decode_original``, the flagship
model with ``use_pos``), the test shows JAX's failure beside the port's
refusal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_convert import TINY
from test_torch_io import ref_state_dict  # noqa: F401  (a fixture)
from test_torch_train import flat, jax_draws, make_batch, torch_batch

from tera_mind_tpu.config import TrainConfig as JConf
from tera_mind_tpu.convert import convert_unet_params as jconvert_unet
from tera_mind_tpu.models import legacy_blocks as jlb
from tera_mind_tpu.models import nn as jnn
from tera_mind_tpu.models import unet_patch_dm as jpd
from tera_mind_tpu.models import unet_sinf as jsf
from tera_mind_tpu.models.unet_packed import PackedTeraUNet as JPacked
from tera_mind_tpu.models.unet_packed import pack_unet_params as jpack
from tera_mind_tpu.training import harness as jh
from tera_mind_tpu_torch import config as tconfig
from tera_mind_tpu_torch.cli import generate as tgen_cli
from tera_mind_tpu_torch.cli import train as ttrain_cli
from tera_mind_tpu_torch.config import TrainConfig as TConf
from tera_mind_tpu_torch.convert import (convert_unet_params,
                                         export_params, load_jax_params)
from tera_mind_tpu_torch.models import legacy_blocks as tlb
from tera_mind_tpu_torch.models import nn as tnn
from tera_mind_tpu_torch.models import unet_patch_dm as tpd
from tera_mind_tpu_torch.models import unet_sinf as tsf
from tera_mind_tpu_torch.models.unet import TeraUNetConfig
from tera_mind_tpu_torch.models.unet_packed import (make_packed_model,
                                                    pack_unet_params)
from tera_mind_tpu_torch.training import harness as th

SMALL = dict(image_size=32, in_channels=4, out_channels=4,
             rna_tpl=(0, 1, 2, 3), rna_num=16, gn_sz=2)
PDM = dict(SMALL, model_channels=8, embed_channels=32, num_res_blocks=1,
           dropout=0.0)
SINF = dict(SMALL, model_channels=8, depth=4)
TRAIN_KW = dict(image_size=32, net_ch=8, embed_channels=32, rna_num=16,
                rna_slices=4, stain="all", batch_size=4, accum_batches=2,
                lr=1e-3, compute_dtype="float32", train_crop=64, dropout=0.0,
                grad_clip=1.0, net_num_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (see tests/test_torch_packed.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(module, *args, seed=0, **kw):
    """Flax param tree of ``module`` with seeded non-zero values: kernels
    scaled by 1/sqrt(fan-in), norm scales 1 + 0.2 z, biases 0.1 z."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            z = z / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "weight", "g"):
            z = 1.0 + 0.2 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol=1e-5):
    """|got - want| within ``tol`` of max(1, |want|max)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def port(module, params):
    """``module`` (float32) with the flax tree ``params`` loaded, eval."""
    return load_jax_params(module, params).eval()


# --------------------------------------------------------------------- #
# blocks                                                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("c", [16, 48, 6, 3])
def test_group_norm32_matches_jax(c):
    """flax GroupNorm's groups and its E[x^2] - E[x]^2 variance, at
    adaptive group counts 16, 16, 2 and 1, on a shifted input."""
    x = randn(np.random.default_rng(c), 2, 2, 8, 8, c) + 3.0
    jm = jlb.GroupNorm32()
    p = seeded(jm, x, seed=1)
    assert tlb.adaptive_groups(c) == jlb.adaptive_groups(c)
    close(port(tlb.GroupNorm32(c), p)(t(x)), jm.apply(p, x))


@pytest.mark.parametrize("kind", ["emb", "down", "up", "no_emb"])
def test_legacy_resblock_matches_jax(kind):
    rng = np.random.default_rng(2)
    cin, cout = (8, 16) if kind in ("emb", "no_emb") else (16, 16)
    x = randn(rng, 2, 2, 8, 8, cin)
    emb = None if kind == "no_emb" else randn(rng, 2, 32)
    kw = dict(up=kind == "up", down=kind == "down")
    jm = jlb.LegacyResBlock3D(out_channels=cout, **kw)
    p = seeded(jm, x, emb, seed=3)
    tm = tlb.LegacyResBlock3D(cin, cout, None if emb is None else 32, **kw)
    close(port(tm, p)(t(x), None if emb is None else t(emb)),
          jm.apply(p, x, emb))


@pytest.mark.parametrize("hw", [16, 8])
def test_window_self_attention_matches_jax(hw):
    """8x8 windows over a 16x16 map; one window of the whole 8x8 map."""
    x = randn(np.random.default_rng(hw), 2, 2, hw, hw, 16)
    jm = jlb.WindowSelfAttention()
    p = seeded(jm, x, seed=4)
    close(port(tlb.WindowSelfAttention(16), p)(t(x)), jm.apply(p, x))


@pytest.mark.parametrize("ksize,pad", [(None, 0), (3, 1), (5, 2), (3, 0)])
def test_equi_group_norm_matches_jax(ksize, pad):
    x = randn(np.random.default_rng(5), 2, 12, 12, 8) + 1.0
    jm = jnn.EquiGroupNorm(num_groups=4, ksize=ksize, pad=pad)
    p = seeded(jm, x, seed=6)
    want = jm.apply(p, x)
    close(port(tnn.EquiGroupNorm(8, 4, ksize=ksize, pad=pad), p)(t(x)),
          want)
    # no affine: no parameters on either side
    jm = jnn.EquiGroupNorm(num_groups=4, ksize=ksize, pad=pad, affine=False)
    tm = tnn.EquiGroupNorm(8, 4, ksize=ksize, pad=pad, affine=False)
    assert not list(tm.parameters())
    close(tm(t(x)), jm.apply({}, x))


def test_time_embed_use_pos_matches_jax():
    rng = np.random.default_rng(7)
    te, pe = randn(rng, 6, 8), randn(rng, 6, 128)
    jm = jnn.TimeEmbed(32, use_pos=True)
    p = seeded(jm, te, pe, seed=8)
    tm = port(tnn.TimeEmbed(8, 32, use_pos=True, pos_channels=128), p)
    close(tm(t(te), t(pe)), jm.apply(p, te, pe))
    with pytest.raises(ValueError, match="position embedding"):
        tm(t(te))


@pytest.mark.parametrize("p1,p2,b", [(2, 2, 1), (3, 2, 2), (1, 4, 3)])
def test_grid_pos_emb_matches_jax(p1, p2, b):
    close(tpd._grid_pos_emb(p1, p2, b), jpd._grid_pos_emb(p1, p2, b))


def test_channel_layer_norm_and_convnext_block_match_jax():
    rng = np.random.default_rng(9)
    x = randn(rng, 3, 16, 16, 12) + 2.0
    jm = jsf.ChannelLayerNorm()
    p = seeded(jm, x, seed=10)
    close(port(tsf.ChannelLayerNorm(12), p)(t(x)), jm.apply(p, x))
    emb = randn(rng, 3, 8)
    for norm in (True, False):
        jm = jsf.ConvNextBlock(out_channels=8, mlp_mult=3, norm=norm)
        p = seeded(jm, x, emb, seed=11)
        tm = tsf.ConvNextBlock(12, 8, 8, mlp_mult=3, norm=norm)
        close(port(tm, p)(t(x), t(emb)), jm.apply(p, x, emb))


# --------------------------------------------------------------------- #
# whole models                                                           #
# --------------------------------------------------------------------- #
def model_inputs(seed, b=2, p1=2, p2=2):
    rng = np.random.default_rng(seed)
    n = b * p1 * p2
    x = randn(rng, n, 32, 32, 4)
    tt = rng.integers(0, 1000, (b,)).astype(np.int32)
    rna = rng.integers(0, 3, (n, 2, 2, 64)).astype(np.float32)
    return x, tt, rna


@pytest.fixture(scope="module")
def patch_dm():
    """(JAX model, seeded params, port model with them)."""
    jm = jpd.PatchDMUNetConfig(**PDM).make_model()
    x, tt, rna = model_inputs(0)
    p = seeded(jm, x, tt, rna, 2, 2, seed=12)
    tm = load_jax_params(tpd.PatchDMUNetConfig(**PDM).make_model(), p)
    return jm, p, tm.eval()


def rel_close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("p1,p2", [(2, 2), (3, 2)])
def test_patch_dm_forward_matches_jax(patch_dm, p1, p2):
    """Both decoders (collage and original patches) from the carried-over
    weights; ``decode_original=False`` returns the same collage."""
    jm, p, tm = patch_dm
    x, tt, rna = model_inputs(p1, p1=p1, p2=p2)
    jcol, jorig = jax.jit(lambda a, b_, c: jm.apply(p, a, b_, c, p1, p2))(
        x, tt, rna)
    with torch.no_grad():
        col, orig = tm(t(x), t(tt), t(rna), p1, p2)
        col_only, none = tm(t(x), t(tt), t(rna), p1, p2,
                            decode_original=False)
    rel_close(col, jcol)
    rel_close(orig, jorig)
    assert none is None
    torch.testing.assert_close(col_only, col, rtol=0, atol=0)


def test_sinf_forward_matches_jax():
    jm = jsf.SinfNetConfig(**SINF).make_model()
    x, tt, rna = model_inputs(1)
    p = seeded(jm, x, tt, rna, 2, 2, seed=13)
    tm = load_jax_params(tsf.SinfNetConfig(**SINF).make_model(), p).eval()
    jcol, jorig = jax.jit(lambda a, b_, c: jm.apply(p, a, b_, c, 2, 2))(
        x, tt, rna)
    with torch.no_grad():
        col, orig = tm(t(x), t(tt), t(rna), 2, 2)
    rel_close(col, jcol)
    rel_close(orig, jorig)


def test_baseline_params_round_trip(patch_dm):
    """``export_params`` gives back the flax tree exactly, leaf for leaf
    (GroupNorm ``scale``/``bias``, ChannelLayerNorm ``g``/``b``, the
    depthwise 7x7 kernel)."""
    _, p, tm = patch_dm
    want = flat(jax.tree.map(np.asarray, p))
    got = flat(export_params(tm))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jm = jsf.SinfNetConfig(**SINF).make_model()
    x, tt, rna = model_inputs(1)
    ps = seeded(jm, x, tt, rna, 2, 2, seed=14)
    tm = load_jax_params(tsf.SinfNetConfig(**SINF).make_model(), ps)
    want, got = flat(jax.tree.map(np.asarray, ps)), flat(export_params(tm))
    assert got.keys() == want.keys()
    assert want["/params/layer_0/ds_conv/kernel"].shape == (7, 7, 1, 4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_baseline_dtypes_follow_jax_promotion():
    """bf16 compute on float32 master weights: the RNA tower computes in
    bf16 (JAX's ``RNATower(dtype=)``), the rest in float32 (flax modules
    without ``dtype=`` promote to their float32 params); generation
    weights are bf16 with ``time_embed`` float32."""
    conf = tpd.PatchDMUNetConfig(**dict(PDM, dtype_name="bfloat16"))
    train = conf.make_model(torch.float32)
    assert train.rna_tower.gene_attn.q.dtype == torch.bfloat16
    assert train.stem.dtype == train.mid_attn.qkv.dtype == torch.float32
    gen = conf.make_model()
    assert gen.stem.weight.dtype == torch.bfloat16
    assert gen.time_embed.time_0.weight.dtype == torch.float32
    tnn.init_weights(train, 0)
    x, tt, rna = model_inputs(3)
    with torch.no_grad():
        col, orig = train.eval()(t(x), t(tt), t(rna), 2, 2)
    assert col.dtype == orig.dtype == torch.float32
    assert torch.isfinite(col).all() and torch.isfinite(orig).all()


# --------------------------------------------------------------------- #
# training                                                               #
# --------------------------------------------------------------------- #
def jax_train_step(method, seed):
    """One accumulated (2 microbatches), clipped Adam step of JAX's jitted
    train step from seeded params: (conf, batch, key, state before and
    after as numpy trees, loss)."""
    conf = JConf(**TRAIN_KW, method=method)
    model = conf.make_model_conf().make_model()
    opt = jh.make_optimizer(conf)
    step = jax.jit(jh.make_train_step(model, conf.make_train_sampler(), opt,
                                      conf))
    params = jax.tree.map(jnp.asarray, seeded(
        model, np.zeros((4, 32, 32, 4), np.float32),
        np.zeros((1,), np.int32), np.zeros((4, 2, 2, 64), np.float32), 2, 2,
        seed=seed))
    state = jh.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=opt.init(params))
    batch = make_batch(conf, seed=seed)
    key = jax.random.PRNGKey(seed)
    before = jax.tree.map(np.asarray, state)
    state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                       key)
    return conf, batch, key, before, jax.tree.map(np.asarray, state), \
        float(loss)


@pytest.mark.parametrize("method", ["patch-dm", "sinf"])
def test_baseline_train_step_matches_jax(method):
    """The port's trainer builds the baseline from ``method`` and, from
    JAX's state with JAX's draws injected, takes the same step."""
    jconf, batch, key, before, after, jloss = jax_train_step(method, 21)
    tr = th.Trainer(TConf(**TRAIN_KW, method=method), device="cpu")
    assert type(tr.model) is {"patch-dm": tpd.PatchDMUNet,
                              "sinf": tsf.SinfNet}[method]
    state = tr.state_from_tree(before)
    state, loss = tr.train_step(state, torch_batch(batch),
                                jax_draws(jconf, batch, key))
    assert abs(float(loss) - jloss) <= 1e-4, (float(loss), jloss)
    mu = flat(tr.state_tree(state)["mu"])
    jmu = flat(after.opt_state[1][0].mu)
    assert mu.keys() == jmu.keys()
    # a conv bias whose channels reach only a GroupNorm with one channel
    # per group (which takes each channel's mean away) has a gradient of
    # 0 but for rounding: there both sides must stay below the floor
    floor = 1e-6 * max(np.abs(g).max() for g in jmu.values())
    vanish = {k for k in jmu if np.abs(jmu[k]).max() <= floor}
    assert all(k.endswith("_conv/bias") for k in vanish), vanish
    for k in jmu:
        if k in vanish:
            assert np.abs(mu[k]).max() <= floor, k
            continue
        top = np.abs(jmu[k]).max()
        assert np.abs(mu[k] - jmu[k]).max() <= 2e-3 * top, k


def test_cli_train_patch_dm_then_generate_on_the_cpu(tmp_path, monkeypatch):
    """``cli.train --method patch-dm`` writes a checkpoint whose
    config.json names the method; ``cli.generate --no_packed`` builds the
    PatchDMUNet from it and generates finite tiles."""
    monkeypatch.chdir(tmp_path)
    state = ttrain_cli.main(["--synthetic", "--device", "cpu", "--max_steps",
                             "2", "--net_ch", "8", "--patch", "32",
                             "--batch", "64", "--method", "patch-dm"])
    assert state.step == 2
    run = tmp_path / "checkpoints" / "638850_32_229_all_4_patch-dm"
    assert TConf.load(run / "config.json").method == "patch-dm"
    assert th.checkpoint_steps(run / "ckpt") == [2]
    gconf = tgen_cli.GeneratorConfig
    monkeypatch.setattr(tgen_cli, "GeneratorConfig",
                        lambda **kw: gconf(**{**kw, "n_slices": 4}))
    argv = ["--ckpt_pth", str(run / "ckpt"), "--device", "cpu",
            "--synthetic", "--hnm", "1", "--wnm", "1", "--tot_epoch", "2",
            "--out_dir", str(tmp_path / "tiles")]
    gen, model, _, _ = tgen_cli.build(tgen_cli.parse_args(argv +
                                                          ["--no_packed"]))
    assert isinstance(model, tpd.PatchDMUNet)
    assert model.conf.model_channels == 8
    out = tgen_cli.main(argv + ["--no_packed"])
    assert out.shape == (256, 256, 8) and np.isfinite(out).all()
    # without --no_packed: the packed layout is refused, as JAX fails
    with pytest.raises(SystemExit, match="--no_packed"):
        tgen_cli.build(tgen_cli.parse_args(argv))


# --------------------------------------------------------------------- #
# where the JAX package fails                                            #
# --------------------------------------------------------------------- #
def test_sinf_without_decode_original_fails_in_jax_and_is_refused(
        tmp_path):
    jm = jsf.SinfNetConfig(**SINF).make_model()
    x, tt, rna = model_inputs(4)
    p = seeded(jm, x, tt, rna, 2, 2, seed=15)
    with pytest.raises(TypeError, match="decode_original"):
        jm.apply(p, x, tt, rna, 2, 2, decode_original=False)
    # the port's model takes no decode_original either ...
    tm = load_jax_params(tsf.SinfNetConfig(**SINF).make_model(), p)
    with pytest.raises(TypeError, match="decode_original"):
        tm(t(x), t(tt), t(rna), 2, 2, decode_original=False)
    # ... so generation and the trainer's preview refuse sinf
    conf = TConf(**TRAIN_KW, method="sinf")
    run = tmp_path / "run"
    run.mkdir()
    conf.save(run / "config.json")
    (run / "ckpt").mkdir()
    for extra in ([], ["--no_packed"]):
        with pytest.raises(SystemExit, match="decode_original"):
            tgen_cli.build(tgen_cli.parse_args(
                ["--ckpt_pth", str(run / "ckpt"), "--device", "cpu",
                 "--synthetic", *extra]))
    tr = th.Trainer(conf, device="cpu")
    batch = make_batch(conf)
    with pytest.raises(ValueError, match="decode_original"):
        tr.preview(tr.init_state(), {k: v[0] for k, v in batch.items()},
                   str(tmp_path / "samples"), 1)


@pytest.mark.parametrize("method", ["patch-dm", "sinf"])
def test_packed_baseline_fails_in_jax_and_is_refused(method):
    jconf = JConf(**TRAIN_KW, method=method)
    jmc = jconf.make_model_conf()
    x, tt, rna = model_inputs(5, b=1)
    params = seeded(jmc.make_model(), x, tt, rna, 2, 2, seed=16)
    with pytest.raises((KeyError, AttributeError)):
        jpack(jax.tree.map(np.asarray, params), jmc)
    with pytest.raises((AssertionError, AttributeError)):
        JPacked(jmc, from_5d=True).init(jax.random.PRNGKey(0), x, tt, rna,
                                       2, 2)
    tconf = TConf(**TRAIN_KW, method=method)
    tmc = tconf.make_model_conf()
    with pytest.raises(ValueError, match="packed layout"):
        pack_unet_params(params, tmc)
    with pytest.raises(ValueError, match="packed layout"):
        make_packed_model(tmc, torch.float32, from_5d=True)
    with pytest.raises(ValueError, match="packed layout"):
        th.Trainer(dataclasses.replace(tconf, packed_compute=True),
                   device="cpu")


def test_ours_use_pos_fails_in_jax_and_is_refused():
    """JAX's TeraUNet with ``use_pos`` asserts at its first call that a
    position embedding was passed; no caller passes one.  The port
    accepts the config (as JAX does) and refuses to build the model."""
    jconf = JConf(**TRAIN_KW, use_pos=True)
    jmc = jconf.make_model_conf()
    assert jmc.use_pos
    x, tt, rna = model_inputs(6, b=1)
    with pytest.raises(AssertionError):
        jmc.make_model().init(jax.random.PRNGKey(0), x, tt, rna, 2, 2)
    tmc = TConf(**TRAIN_KW, use_pos=True).make_model_conf()
    assert isinstance(tmc, TeraUNetConfig) and tmc.use_pos
    with pytest.raises(ValueError, match="use_pos"):
        tmc.make_model()
    with pytest.raises(ValueError, match="use_pos"):
        make_packed_model(tmc, torch.float32, from_5d=True)


@pytest.mark.parametrize("name", ["638850_64_229_all_4_patch-dm",
                                  "609882_32_500_PolyT_4_sinf"])
def test_config_from_name_takes_the_baselines(name):
    from tera_mind_tpu.config import config_from_name as jfrom_name
    tc, jc = tconfig.config_from_name(name), jfrom_name(name)
    assert tc.method == jc.method == name.rsplit("_", 1)[1]
    tm, jm = tc.make_model_conf(), jc.make_model_conf()
    assert type(tm).__name__ == type(jm).__name__
    for f in dataclasses.fields(tm):
        assert getattr(tm, f.name) == getattr(jm, f.name), f.name


def test_reference_ckpt_of_a_baseline_fails_in_jax_and_is_refused(
        ref_state_dict):  # noqa: F811
    """JAX's conversion builds a TeraUNet tree whatever the config, which
    a PatchDMUNet cannot apply; the port's conversion refuses the
    baseline's config."""
    kw = {f: getattr(TINY, f) for f in ("image_size", "gn_sz", "rna_num",
                                        "rna_tpl", "in_channels",
                                        "out_channels", "model_channels",
                                        "embed_channels")}
    jmc = jpd.PatchDMUNetConfig(**kw, dropout=0.0)
    params = jconvert_unet(ref_state_dict, jmc)
    x, tt, rna = model_inputs(8, b=1)
    with pytest.raises(Exception, match="[Pp]aram"):
        jmc.make_model().apply(params, x, tt, rna, 2, 2)
    with pytest.raises(ValueError, match="'ours' model only"):
        convert_unet_params(ref_state_dict, tpd.PatchDMUNetConfig(**kw))

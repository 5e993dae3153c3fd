"""The port against the JAX package at the other published presets, on
the CPU in f32.

Four presets: 638850 (229 genes, patch 64, two stains, 4 RNA slices),
609882 (its 500-gene panel), 609889 with the 81-gene M2H panel
(``--to_hbr``) at patch 128 and 8 RNA slices, and 609882 at patch 32
with one stain (DAPI) and 16 RNA slices.  Each runs at a small width
(``net_ch`` 8, one ResBlock a level, ``embed_channels`` 32) with every
other field of the preset, seeded non-zero flax params carried into the
port by ``convert.py`` (and ``pack_unet_params`` for the packed model),
and the same numpy inputs on both sides; the JAX side jitted, its
kernels on their XLA paths, the port's on their plain versions.

- config, constants and the generator's derived sizes equal JAX's;
- the 5D and the packed UNet forward: max |d| within 1e-5 of the
  output's max;
- one training step of the port's ``Trainer`` (``shape_batch``, the
  dual-decoder loss, the backward) against ``jax.value_and_grad`` of JAX's
  training loss with the same noise, timesteps and block origin: the loss
  within 1e-5 relative, each gradient leaf within 1e-4 of its max;
- one block-major generator step over 2x2 tiles (of 64 px, 128 at patch
  128) within 1e-5 of the output's max, through a cheap stand-in model that reads
  every pixel and gene channel for every preset, and through the real
  packed UNet where the preset's z-windows are few (4 RNA slices: the
  stack can be cut to 4 slices; at 8 and 16 slices the generator always
  takes 48 of them, 12 or 6 z-windows of full UNet calls, minutes on the
  CPU).

``scripts/kernel_shapes.py``'s preset listings are held to the shapes the
CPU forward and backward pass to the plain K1 / K1b / K2 / K2b / K3 / K4
functions.
"""

import dataclasses
import importlib.util
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import seeded_params

from tera_mind_tpu import config as jconfig
from tera_mind_tpu import constants as jconst
from tera_mind_tpu.diffusion.sampler import DiffusionSampler as JSampler
from tera_mind_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from tera_mind_tpu.diffusion.schedule import spaced_schedule as j_spaced
from tera_mind_tpu.models import unet_packed as jpk
from tera_mind_tpu.ops import collage as jcollage
from tera_mind_tpu.parallel import generator as jgen
from tera_mind_tpu_torch import config as tconfig
from tera_mind_tpu_torch import constants as tconst
from tera_mind_tpu_torch.convert import (export_params, export_tensors,
                                         load_jax_params)
from tera_mind_tpu_torch.diffusion.sampler import DiffusionSampler
from tera_mind_tpu_torch.diffusion.sampler import SamplerConfig
from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
from tera_mind_tpu_torch.models import unet_packed as tpk
from tera_mind_tpu_torch.ops import attention_kernel as k2
from tera_mind_tpu_torch.ops import collage as tcollage
from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
from tera_mind_tpu_torch.ops import quant_kernel as qk
from tera_mind_tpu_torch.ops import residual_kernel as k6
from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1
from tera_mind_tpu_torch.parallel import generator as tgen
from tera_mind_tpu_torch.training import harness as th

# (mouse, patch, genes, stain, RNA slices)
PRESETS = [("638850", 64, 229, "all", 4), ("609882", 64, 500, "all", 4),
           ("609889", 128, 81, "all", 8), ("609882", 32, 500, "DAPI", 16)]
IDS = ["_".join(map(str, p)) for p in PRESETS]
SMALL = dict(net_ch=8, embed_channels=32, net_num_res_blocks=1,
             compute_dtype="float32", dropout=0.0, batch_size=1,
             accum_batches=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (see tests/test_torch_packed.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def confs(preset):
    """(JAX, port) ``TrainConfig`` of the preset at the small width."""
    mouse, size, nrna, stain, srna = preset
    out = []
    for mod in (jconfig, tconfig):
        c = mod.prep_config(mouse, size=size, nrna=nrna, stain=stain,
                            srna=srna)
        for k, v in SMALL.items():
            setattr(c, k, v)
        out.append(c)
    return out


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def rel_close(got, want, tol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def model_inputs(conf, seed=0):
    """A 2x2 block of patches of the preset, one timestep, its gene bins."""
    rng = np.random.default_rng(seed)
    p = conf.image_size
    x = rng.standard_normal((4, p, p, conf.in_channels)).astype(np.float32)
    rna = rng.integers(0, 3, (4, conf.gn_sz, conf.gn_sz,
                              conf.rna_slices * conf.rna_num)
                       ).astype(np.float32)
    return x, np.array([617], np.int32), rna


def train_inputs(conf):
    """One loader sample of the preset (a 2x2-patch crop and its gene
    bins), its padding, noise, timestep and block origin."""
    p = conf.image_size
    rng = np.random.default_rng(2)
    crop, gh = 2 * p, 2 * p // 16 + conf.gn_sz
    image = rng.uniform(-1, 1, (1, crop, crop, conf.in_channels)
                        ).astype(np.float32)
    rna = rng.integers(0, 3, (1, gh, gh, conf.rna_slices * conf.rna_num)
                       ).astype(np.float32)
    x_pad = np.pad(image, ((0, 0), (p // 2,) * 2, (p // 2,) * 2, (0, 0)))
    noise = rng.standard_normal(x_pad.shape).astype(np.float32)
    return dict(image=image, rna=rna, x_pad=x_pad, noise=noise,
                t=np.array([431], np.int32), block=(1, 0))


def jax_forward(case):
    """JAX's 5D and packed UNet on ``model_inputs(seed=1)``."""
    jm = case["jconf"].make_model_conf()
    x, t, rna = model_inputs(case["jconf"], seed=1)
    j5, jp = jm.make_model(), jpk.PackedTeraUNet(jm)

    def run(p5, pp):
        return (j5.apply(p5, x, t, rna, 2, 2),
                jp.apply(pp, x, t, rna, 2, 2))
    return jax.block_until_ready(jax.jit(run)(case["params"], case["packed"]))


def jax_train(case):
    """``jax.value_and_grad`` of JAX's training loss on
    :func:`train_inputs` with its noise, timestep and block origin."""
    conf = case["jconf"]
    d = train_inputs(conf)
    jmodel = conf.make_model_conf().make_model()
    jsampler = conf.make_train_sampler()

    def run(params):
        def loss(p_):
            def fn(xp, tm, rp, p1, p2):
                return jmodel.apply(p_, xp, tm, rp, p1, p2)
            return jsampler.training_loss(
                fn, d["x_pad"], d["rna"], d["t"], jax.random.PRNGKey(0),
                noise=d["noise"], block_idx=d["block"])
        return jax.value_and_grad(loss)(params)
    return jax.block_until_ready(jax.jit(run)(case["params"]))


@pytest.fixture(scope="module", params=PRESETS, ids=IDS)
def case(request):
    """The preset's configs, the seeded flax tree of its small 5D model and
    that tree packed by JAX (numpy leaves), and the JAX side of each test
    below already started on worker threads (``case["jax"][name]``, a
    future): XLA compiles and runs them in parallel, releasing the GIL,
    while the tests run the port."""
    jconf, tconf = confs(request.param)
    jm = jconf.make_model_conf()
    x, t, rna = model_inputs(jconf)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), seeded_params(
        jm.make_model(), x, t, rna, 2, 2, seed=16))
    c = dict(preset=request.param, jconf=jconf, tconf=tconf, params=params,
             packed=jpk.pack_unet_params(params, jm))
    jobs = {"forward": jax_forward, "train": jax_train,
            "stand_in": lambda c_: jax_step(c_, "stand_in")}
    if jconf.rna_slices == 4:
        jobs["unet"] = lambda c_: jax_step(c_, "unet")
    pool = ThreadPoolExecutor(len(jobs))
    c["jax"] = {name: pool.submit(fn, c) for name, fn in jobs.items()}
    pool.shutdown(wait=False)
    return c


# --------------------------------------------------------------------- #
# config, constants, derived sizes                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("preset", PRESETS, ids=IDS)
def test_preset_config_matches_jax(preset):
    """``prep_config`` and ``config_from_name`` of the preset, its model
    config, the M2H panel and the generator's derived sizes equal JAX's;
    the name round-trips through ``cli.generate``'s checkpoint rule."""
    mouse, size, nrna, stain, srna = preset
    tc = tconfig.prep_config(mouse, size=size, nrna=nrna, stain=stain,
                             srna=srna)
    jc = jconfig.prep_config(mouse, size=size, nrna=nrna, stain=stain,
                             srna=srna)
    assert tc.name == jc.name == f"{mouse}_{size}_{nrna}_{stain}_{srna}_ours"
    for c in (tc, tconfig.config_from_name(tc.name)):
        for f in dataclasses.fields(c):
            assert getattr(c, f.name) == getattr(jc, f.name), f.name
    assert (tc.rna_tpl, tc.gn_sz, tc.z_size, tc.in_channels) == \
        (jc.rna_tpl, jc.gn_sz, jc.z_size, jc.in_channels)
    tm, jm = tc.make_model_conf(), jc.make_model_conf()
    for f in dataclasses.fields(tm):
        assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    assert tconst.M2H == jconst.M2H and len(tconst.M2H) == 81
    assert tconst.M2H_NAMES == jconst.M2H_NAMES
    assert tpk._block_segments(tm) == jpk._block_segments(jm)
    kw = dict(patch=size, snum=srna, stains=2 if stain == "all" else 1)
    g, j = tgen.GeneratorConfig(**kw), jgen.GeneratorConfig(**kw)
    for name in ("pad", "spad", "zi", "n_win", "z_use", "channels",
                 "z_pad", "gsz"):
        assert getattr(g, name) == getattr(j, name), name
    # the 2x2 plan off the card, as JAX's auto_plan takes it off the TPU
    sched = (j_spaced("linear", 1000, "ddim3"),
             spaced_schedule("linear", 1000, "ddim3"))
    jg = jgen.TeraGenerator(JSampler(sched[0], JSamplerConfig(
        patch_size=size, gn_sz=size // 16)), lambda *a: a[0], j)
    tg = tgen.TeraGenerator(DiffusionSampler(sched[1], SamplerConfig(
        patch_size=size, gn_sz=size // 16)), lambda *a: a[0], g,
        device="cpu")
    assert tg.auto_plan(2, 2, verbose=False) == jg.auto_plan(
        2, 2, verbose=False)


# --------------------------------------------------------------------- #
# the model                                                              #
# --------------------------------------------------------------------- #
def test_unet_forward_matches_jax(case):
    """The 5D and the packed UNet on a 2x2 block of the preset: both
    decoders within 1e-5 of the output's max; the carried trees bit-equal
    (``export_params`` back, the port's ``pack_unet_params`` against
    JAX's)."""
    tm = case["tconf"].make_model_conf()
    x, t, rna = model_inputs(case["tconf"], seed=1)
    model5 = load_jax_params(tm.make_model(), case["params"])
    tree = tpk.pack_unet_params(export_params(model5), tm)
    assert flat(export_params(model5)).keys() == flat(case["params"]).keys()
    for k, v in flat(export_params(model5)).items():
        np.testing.assert_array_equal(v, flat(case["params"])[k], err_msg=k)
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(v, flat(case["packed"])[k], err_msg=k)
    packed = load_jax_params(tpk.make_packed_model(tm), tree)
    args = (torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(rna), 2, 2)
    with torch.no_grad():
        outs = [(model(*args), what) for model, what in ((model5, "5d"),
                                                         (packed, "packed"))]
    for (got, what), want in zip(outs, case["jax"]["forward"].result()):
        assert len(got) == len(want) == 2
        for g, w, dec in zip(got, want, ("collage", "original")):
            assert g.shape == w.shape
            rel_close(g.numpy(), w, 1e-5, f"{what} {dec}")


# --------------------------------------------------------------------- #
# one training step                                                      #
# --------------------------------------------------------------------- #
def test_train_step_matches_jax(case, monkeypatch):
    """The port's ``Trainer`` (5D, ``shape_batch`` of a one-sample loader
    batch, the dual-decoder loss and its backward) against
    ``jax.value_and_grad`` of JAX's ``training_loss`` on the same image,
    genes, noise, timestep and 2x2 block origin: the loss within 1e-5
    relative, every gradient leaf within 1e-4 of its max.  The K1, K1b,
    K2 and K2b shapes the step passes to the plain functions are those
    ``scripts/kernel_shapes.py`` lists for the microbatch."""
    tconf = case["tconf"]
    d = train_inputs(tconf)
    tr = th.Trainer(tconf, device="cpu")
    tr.state_from_params(case["params"])
    batch = tr.shape_batch({"image": d["image"], "rna": d["rna"]})
    assert batch["image"].shape == (1, 1) + d["image"].shape[1:]
    rec = PlainRecorder(monkeypatch)
    loss, grads = tr.loss_and_grads(batch, [(
        torch.from_numpy(d["t"]).long(), torch.from_numpy(d["noise"]),
        d["block"])])
    # the shapes scripts/kernel_shapes.py lists for this microbatch
    k1s, k2s = kernel_shapes().train_shapes(conf=tconf)
    assert (rec.k["K1"], rec.k["K2"]) == (k1s, k2s)
    assert (rec.k["K1b"], rec.k["K2b"]) == (k1s, k2s)
    jloss, jgrads = case["jax"]["train"].result()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got, want = flat(export_tensors(grads)), flat(jgrads)
    assert got.keys() == want.keys()
    for k, w in want.items():
        rel_close(got[k], w, 1e-4, k)


# --------------------------------------------------------------------- #
# one block-major generator step                                         #
# --------------------------------------------------------------------- #
def stand_in(xp, tm, rp, p1, p2, lib):
    """A cheap model function, the same in jnp and torch: each patch's
    value from every pixel channel, its gene bins (mean over genes and z,
    each bin over its 16 x 16 px) and the call's timestep; the collage
    cells (the interior (p1 - 1) x (p2 - 1) patches of the assembled
    grid) as eps, (eps, None) as the UNet's (collage, original) with
    ``decode_original=False``."""
    n, p, _, c = xp.shape
    gn = rp.shape[1]
    g = rp.reshape(n, gn, 1, gn, 1, -1).mean(-1)
    if lib is jnp:
        g = jnp.broadcast_to(g, (n, gn, p // gn, gn, p // gn))
        t = jnp.repeat(tm, n // tm.shape[0]).astype(jnp.float32)
        mix = jnp.tanh(0.7 * xp + 0.3 * xp.mean(-1, keepdims=True))
        patchify, unpatchify = jcollage.patchify, jcollage.unpatchify
    else:
        g = g.expand(n, gn, p // gn, gn, p // gn)
        t = tm.repeat_interleave(n // tm.shape[0]).float()
        mix = torch.tanh(0.7 * xp + 0.3 * xp.mean(-1, keepdim=True))
        patchify, unpatchify = tcollage.patchify, tcollage.unpatchify
    out = (mix + 0.05 * g.reshape(n, p, p, 1)
           + 1e-4 * t[:, None, None, None])
    img = unpatchify(out, p1, p2)[:, p // 2:-(p // 2), p // 2:-(p // 2)]
    return patchify(img, p), None


def step_setup(case):
    """The generator config of 2x2 tiles of the preset (64 px, 128 at
    patch 128), its gene stack and the 3-step DDIM schedule's sampler
    config."""
    conf = case["jconf"]
    p, srna = conf.image_size, conf.rna_slices
    kw = dict(tile=max(64, p), patch=p, gn_blk=16, snum=srna,
              n_slices=4 if srna in (1, 4) else 50,
              stains=2 if conf.stain == "all" else 1, gdim=500,
              window_chunk=1)
    gsz = tgen.GeneratorConfig(**kw).gsz
    z_pad = tgen.GeneratorConfig(**kw).z_pad
    gene = np.random.default_rng(5).integers(
        0, 3, (2, 2, gsz, gsz, z_pad, 500)).astype(np.uint8)
    return kw, gene, dict(patch_size=p, gn_sz=conf.gn_sz)


def jax_step(case, model):
    """(initial state, JAX's one block-major step) over 2x2 tiles of the
    preset; ``model`` "stand_in" or "unet" (the packed UNet on the case's
    tree)."""
    kw, gene, skw = step_setup(case)
    sampler = JSampler(j_spaced("linear", 1000, "ddim3"),
                       JSamplerConfig(**skw))
    if model == "stand_in":
        jg = jgen.TeraGenerator(sampler, lambda *a: stand_in(*a, lib=jnp),
                                jgen.GeneratorConfig(**kw))
    else:
        jm = jpk.PackedTeraUNet(case["jconf"].make_model_conf())
        jg = jgen.TeraGenerator(
            sampler, lambda prm, xp, tm, rp, p1, p2: jm.apply(
                prm, xp, tm, rp, p1, p2, decode_original=False),
            jgen.GeneratorConfig(**kw), params=case["packed"])
    state = jg.init_state(2, 2, row0=1, col0=1, grid_w=16)
    return state, np.asarray(jg.compile_step(2, 2, block_major=True)(
        jnp.asarray(state), jnp.asarray(gene), 2))


def step_pair(case, model):
    """(port, JAX) one block-major step's outputs over 2x2 tiles of the
    preset, from the same initial noise and gene stack."""
    kw, gene, skw = step_setup(case)
    gt = tgen.GeneratorConfig(**kw)
    sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                               SamplerConfig(**skw))
    if model == "stand_in":
        tg = tgen.TeraGenerator(
            sampler, lambda *a: stand_in(*a, lib=torch), gt, device="cpu")
    else:
        pm = load_jax_params(tpk.make_packed_model(
            case["tconf"].make_model_conf()), case["packed"])
        tg = tgen.TeraGenerator(
            sampler, lambda xp, t_, rp, p1, p2: pm(
                xp, t_, rp, p1, p2, decode_original=False),
            gt, device="cpu")
    state = tg.init_state(2, 2, row0=1, col0=1, grid_w=16)
    with torch.no_grad():
        got = tg.compile_step(2, 2, block_major=True)(
            torch.from_numpy(state), torch.from_numpy(gene), 2).numpy()
    jstate, want = case["jax"][model].result()
    np.testing.assert_array_equal(state, jstate)
    assert got.shape == want.shape == (2 * gt.tile, 2 * gt.tile,
                                       gt.channels)
    return got, want


def test_generator_step_matches_jax(case):
    """One block-major step (the highest timestep of a 3-step DDIM) over
    2x2 tiles of the preset: the patch grid, the preset's z-windows (25,
    12 or 6 of 48 slices), its stains and the M2H or first-N gene
    selection from 500 carried genes, through the stand-in model for
    every preset and the packed UNet where the preset has 4 RNA slices:
    max |d| within 1e-5 of the output's max (the step's x0 estimate
    scales eps by sqrt(1 / abar - 1), about 4 at this timestep)."""
    got, want = step_pair(case, "stand_in")
    rel_close(got, want, 1e-5, "stand-in step")
    if case["jconf"].rna_slices == 4:
        got, want = step_pair(case, "unet")
        assert np.isfinite(got).all()
        rel_close(got, want, 1e-5, "UNet step")


# --------------------------------------------------------------------- #
# scripts/kernel_shapes.py at the presets                                #
# --------------------------------------------------------------------- #
def kernel_shapes():
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", Path(__file__).resolve().parent.parent / "scripts"
        / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    return ks


class PlainRecorder:
    """Records the shapes the port's plain K1, K1b, K2, K2b, K3, K4, K5,
    K5b and K6 functions get (their dispatchers look them up in the
    module at each call)."""

    def __init__(self, monkeypatch):
        self.k = {n: Counter() for n in ("K1", "K1b", "K2", "K2b", "K3",
                                         "K4", "K5", "K5b", "K6")}
        ci = {}

        def wrap(mod, name, key):
            fn = getattr(mod, name)

            def rec(*a, **kw):
                out = fn(*a, **kw)
                self.k[key][shape_of(key, a, kw, out, ci)] += 1
                return out
            monkeypatch.setattr(mod, name, rec)
        for mod, name, key in ((k1, "rmsnorm_plain", "K1"),
                               (k1, "rmsnorm_bwd_plain", "K1b"),
                               (k2, "attention_plain", "K2"),
                               (k2, "attention_bwd_plain", "K2b"),
                               (qk, "quantize_plain", "K4"),
                               (qk, "quant_conv_plain", "K3"),
                               (k5, "grouped_rmsnorm_plain", "K5"),
                               (k5, "grouped_rmsnorm_bwd_plain", "K5b"),
                               (k6, "residual_plain", "K6")):
            wrap(mod, name, key)


def shape_of(key, a, kw, out, ci):
    """A recorded call's key, as ``kernel_shapes.py`` keys it."""
    x = a[0]
    if key == "K6":              # (h, h_bias, s, s_bias=None)
        s_bias = a[3] if len(a) > 3 else kw.get("s_bias")
        return (x.numel() // x.shape[-1], x.shape[-1], k6.skip_kind(s_bias))
    if key in ("K5", "K5b"):     # (x[, g], weight, z, segments, ...)
        z, segs = a[2:4] if key == "K5" else a[3:5]
        return (x.numel() // x.shape[-1], tuple(segs), z)
    if key in ("K1", "K1b"):
        return (x.numel() // x.shape[-1], x.shape[-1])
    if key in ("K2", "K2b"):
        return tuple(x.shape)
    if key == "K4":
        a_scale = a[1] if len(a) > 1 else kw.get("a_scale")
        multiple = a[2] if len(a) > 2 else kw.get("multiple",
                                                  qk.CONV_ALIGN)
        ci[id(out[0])] = x.shape[-1]
        return (x.numel() // x.shape[-1], x.shape[-1], multiple,
                qk.quantize_variant(a_scale))
    w = a[1]
    return (tuple(x.shape[:3]) + (ci[id(x)],), tuple(w.shape[:3]))


@pytest.mark.parametrize("preset", PRESETS, ids=IDS)
def test_kernel_shapes_lists_the_cpu_passes_shapes(preset, monkeypatch):
    """For each preset (small width), the K1 / K2 / K5 shapes
    ``kernel_shapes.py`` lists for a generation call of the packed model
    (2x2 patches) and the K3 / K4 / K5 shapes of an int8 call are exactly
    those the CPU forward passes to the plain functions, as often (a
    training microbatch's K1 / K1b / K2 / K2b:
    test_train_step_matches_jax; its K5 / K5b: the packed training
    microbatch here)."""
    ks = kernel_shapes()
    mouse, size, nrna, stain, srna = preset
    conf = ks.preset_conf(mouse, size, nrna == 81, stain, srna, batch=1)
    assert conf.rna_num == nrna
    for k, v in SMALL.items():
        setattr(conf, k, v)
    mconf = conf.make_model_conf()
    x, t, rna = model_inputs(conf, seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(rna), 2, 2)
    rec = PlainRecorder(monkeypatch)

    # generation: the packed model, collage decoder, no gradient; on the
    # CPU the ResBlocks fold their biases and sum (K5's prologue, K6) only
    # when asked, as the card does by default
    k5s, k6s = Counter(), Counter()
    k1s, k2s = ks.per_call_shapes(grid=(2, 2), conf=conf, k5=k5s, k6=k6s)
    model = tpk.make_packed_model(mconf)
    with torch.no_grad():
        model(*args, decode_original=False)
        assert not rec.k["K6"]
        for m in model.modules():
            if isinstance(m, tpk.PackedResBlock):
                m.fold = True
        rec.k["K5"].clear(), rec.k["K1"].clear(), rec.k["K2"].clear()
        model(*args, decode_original=False)
    assert (rec.k["K1"], rec.k["K2"], rec.k["K5"], rec.k["K6"]) == (
        k1s, k2s, k5s, k6s)
    assert sum(k5s.values()) > 0 and sum(k6s.values()) > 0

    # a packed training microbatch (both decoders, the 5D weights): K5
    # and K5b at train_shapes' K5 shapes, once each a call
    rec.k["K5"].clear()
    k5t = Counter()
    ks.train_shapes(True, batch=1, conf=conf, k5=k5t)
    model = tpk.make_packed_model(mconf, torch.float32, from_5d=True)
    pred, orig = model(*args)
    (pred.sum() + orig.sum()).backward()
    assert rec.k["K5"] == rec.k["K5b"] == k5t

    # a training step's prediction counts train_shapes' launches (the
    # shapes themselves: test_train_step_matches_jax)
    k1s, k2s = ks.train_shapes(conf=conf)
    pred = ks.train_prediction(conf, steps=2)
    assert pred["rmsnorm_bwd"]["launches"] == 2 * sum(k1s.values())
    assert pred["window_attention"]["by_variant"] == ks.by_variant(
        "K2", k2s, 2)

    # int8: the prequantized packed model, dynamic activations
    rec.k["K1"].clear(), rec.k["K2"].clear()
    from tera_mind_tpu_torch.ops.quant import prequantize_params
    tree = tpk.pack_unet_params(export_params(mconf.make_model()), mconf)
    qmodel = load_jax_params(tpk.make_packed_model(
        mconf, quant="int8", prequant=True, quant_attn=True),
        prequantize_params(tree, attn=True))
    rec.k["K5"].clear()
    k5q = Counter()
    k3s, k4s, _ = ks.quant_shapes(grid=(2, 2), conf=conf,
                                  k12=(Counter(), Counter(), k5q))
    with torch.no_grad():
        qmodel(*args, decode_original=False)
    assert (rec.k["K3"], rec.k["K4"], rec.k["K5"]) == (k3s, k4s, k5q)

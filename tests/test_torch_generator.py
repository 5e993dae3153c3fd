"""The port's generation chain against the JAX package's, on the CPU.

The slice as a whole: a 2x2-tile, 3-step block-major DDIM chain through
the real TeraUNet (the tiny config of test_generator.py's
test_block_major_real_unet, f32, LCG 'torch' noise), port against
``tera_mind_tpu``.  Plus the pieces: halo pad, bin assembly, initial
state, config presets and the CLI's synthetic gene grid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tera_mind_tpu import config as jconfig
from tera_mind_tpu.cli.generate import synthetic_gene_grid as j_synth
from tera_mind_tpu.diffusion.sampler import DiffusionSampler as JSampler
from tera_mind_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from tera_mind_tpu.diffusion.schedule import spaced_schedule as j_spaced
from tera_mind_tpu.models.unet import TeraUNetConfig as JUNetConfig
from tera_mind_tpu.parallel import generator as jgen
from tera_mind_tpu.parallel.halo import pad_halo_single as j_pad
from tera_mind_tpu_torch import config as tconfig
from tera_mind_tpu_torch.cli import generate as tcli
from tera_mind_tpu_torch.convert import load_jax_params
from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                   SamplerConfig)
from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
from tera_mind_tpu_torch.models.unet import TeraUNetConfig
from tera_mind_tpu_torch.parallel import generator as tgen
from tera_mind_tpu_torch.parallel.halo import pad_halo_single

GKW = dict(tile=64, patch=32, gn_blk=16, snum=4, n_slices=4, stains=1,
           gdim=6, window_chunk=1)
MKW = dict(image_size=32, in_channels=2, out_channels=2, model_channels=8,
           embed_channels=32, num_res_blocks=1, channel_mult=(1, 2, 4, 8),
           attention_resolutions=(8,), rna_num=6, gn_sz=2)


def seeded_params(module, *args, seed=0):
    """Flax param tree with seeded non-zero values in every leaf."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.sqrt(np.prod(s.shape[:-1]))
        return 1.0 + 0.2 * z if name == "weight" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def gene_grid(conf, rows=2, cols=2, seed=9):
    """Per-tile padded bins cut from one global field (consistent halos)."""
    nb, hb = conf.tile // conf.gn_blk, conf.pad // conf.gn_blk
    field = np.random.default_rng(seed).integers(
        0, 3, (rows * nb + 2 * hb, cols * nb + 2 * hb, conf.z_pad,
               conf.gdim)).astype(np.uint8)
    return np.stack([np.stack([field[r * nb:r * nb + nb + 2 * hb,
                                     c * nb:c * nb + nb + 2 * hb]
                               for c in range(cols)]) for r in range(rows)])


@pytest.fixture(scope="module")
def chain():
    """JAX block-major 3-step chain, and a port generator on its params."""
    gconf = jgen.GeneratorConfig(**GKW, noise_backend="torch")
    jm = JUNetConfig(**MKW, dropout=0.0).make_model()
    params = seeded_params(jm, np.zeros((4, 32, 32, 2), np.float32),
                           np.zeros((1,), np.int32),
                           np.zeros((4, 2, 2, 24), np.float32), 2, 2)
    jsampler = JSampler(j_spaced("linear", 1000, "ddim3"),
                        JSamplerConfig(patch_size=32, gn_sz=2))
    jg = jgen.TeraGenerator(
        jsampler,
        lambda p, xp, tm, rp, p1, p2: jm.apply(p, xp, tm, rp, p1, p2,
                                               decode_original=False),
        gconf, params=params)
    gene = gene_grid(gconf)
    want = jg.run(gene, row0=1, col0=1, grid_w=16, block_major=True,
                  progress=False)

    model = load_jax_params(TeraUNetConfig(**MKW).make_model(), params)

    def port(**over):
        sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                                   SamplerConfig(patch_size=32, gn_sz=2))
        return tgen.TeraGenerator(
            sampler,
            lambda xp, tm, rp, p1, p2: model(xp, tm, rp, p1, p2,
                                             decode_original=False),
            tgen.GeneratorConfig(**{**GKW, **over}), device="cpu")

    return gene, np.asarray(want), jg, port


def test_block_major_chain_matches_jax(chain):
    """The slice end to end: 2x2 tiles x 3 DDIM steps.  2e-4 absolute:
    f32 reassociation in the convs, amplified by the DDIM 1/sqrt(abar)
    factor at the largest t."""
    gene, want, _, port = chain
    got = port().run(gene, row0=1, col0=1, grid_w=16, block_major=True,
                     progress=False)
    assert got.shape == want.shape == (128, 128, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("over", [{"window_chunk": 0}, {"strip_rows": 1}])
def test_chunking_and_strips_do_not_change_the_step(chain, over):
    """Window chunks and row strips give the block-major step's result
    within 1e-5 absolute, and so does the tile-major step (the JAX
    package's test_block_major_matches_tile_path) within 2e-4, the UNet
    chains' tolerance: its per-tile batches of another shape reassociate
    the convs' f32 sums."""
    gene, _, _, port = chain
    base, other = port(), port(**over)
    state = torch.from_numpy(base.init_state(2, 2, row0=1, col0=1,
                                             grid_w=16))
    g = torch.from_numpy(gene)
    want = base.compile_step(2, 2, block_major=True)(state, g, 2).numpy()
    np.testing.assert_allclose(
        other.compile_step(2, 2, block_major=True)(state, g, 2).numpy(),
        want, atol=1e-5)
    assert base.compile_step(2, 2, block_major=False) == base._block_step
    np.testing.assert_allclose(
        other.compile_step(2, 2, block_major=False)(state, g, 2).numpy(),
        want, atol=2e-4)
    with pytest.raises(ValueError):
        port(window_chunk=3).compile_step(2, 2, block_major=True)(state, g,
                                                                  2)


def test_init_state_is_bit_exact(chain):
    _, _, jg, port = chain
    np.testing.assert_array_equal(
        port().init_state(2, 3, row0=4, col0=2, grid_w=16),
        jg.init_state(2, 3, row0=4, col0=2, grid_w=16))


def test_halo_pad_and_bin_assembly_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(pad_halo_single(torch.from_numpy(x), 4),
                                  np.asarray(j_pad(jnp.asarray(x), 4)))
    tiles = rng.integers(0, 9, (2, 3, 6, 6, 5, 2)).astype(np.uint8)
    np.testing.assert_array_equal(
        tgen.assemble_bins(torch.from_numpy(tiles), 4, 1).numpy(),
        np.asarray(jgen.assemble_bins(jnp.asarray(tiles), 4, 1)))


@pytest.mark.parametrize("mouse", ["638850", "609882"])
def test_config_presets_match_jax(mouse):
    tc, jc = tconfig.prep_config(mouse), jconfig.prep_config(mouse)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.rna_tpl, tc.gn_sz, tc.z_size, tc.in_channels) == \
        (jc.rna_tpl, jc.gn_sz, jc.z_size, jc.in_channels)
    # the port's configs hold the fields inference reads; the JAX preset's
    # other fields must select what the port runs (no position embedding,
    # deterministic DDIM)
    tm, jm = tc.make_model_conf(), jc.make_model_conf()
    for f in dataclasses.fields(tm):
        assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    assert not jm.use_pos
    ts, js = tc.make_eval_sampler(T=15), jc.make_eval_sampler(T=15)
    for f in dataclasses.fields(ts.conf):
        assert getattr(ts.conf, f.name) == getattr(js.conf, f.name), f.name
    assert (js.conf.gen_type, js.conf.eta) == ("ddim", 0.0)
    np.testing.assert_array_equal(ts.schedule.alphas_cumprod.numpy(),
                                  np.asarray(js.schedule.alphas_cumprod))
    gc = tgen.GeneratorConfig()
    jg = jgen.GeneratorConfig()
    assert (gc.n_win, gc.channels, gc.z_pad, gc.gsz, gc.spad) == \
        (jg.n_win, jg.channels, jg.z_pad, jg.gsz, jg.spad) == \
        (25, 100, 52, 20, 1)


def test_cli_synthetic_grid_and_args():
    np.testing.assert_array_equal(tcli.synthetic_gene_grid(2, 3, 20, 6, 5),
                                  j_synth(2, 3, 20, 6, 5))


@pytest.mark.parametrize("shape", [(3, 3, 20, 52, 60), (2, 3, 20, 51, 229)])
def test_synthetic_grid_matches_jax_across_chunks(shape):
    """The port draws the synthetic field in chunks of 2^22 bins; a field
    of several chunks, the last one partial, is JAX's, bin for bin."""
    np.testing.assert_array_equal(tcli.synthetic_gene_grid(*shape),
                                  j_synth(*shape))
    args = tcli.parse_args(["--synthetic", "--hnm", "2", "--wnm", "2"])
    assert (args.device, args.window_chunk, args.tot_epoch, args.mouse) == \
        ("cuda", -1, 15, "638850")
    with pytest.raises(SystemExit):     # an orbax directory: not ported
        tcli.build(tcli.parse_args(["--ckpt_pth",
                                    "runs/638850_64_229_all_4_ours"]))
    with pytest.raises(ValueError):
        tconfig.prep_config("000000")

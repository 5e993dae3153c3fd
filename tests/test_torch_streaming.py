"""The port's tile-major step, memory planner and host streaming against
the JAX package's, on the CPU.

Same numpy inputs (from seeds) through ``tera_mind_tpu`` and
``tera_mind_tpu_torch``: the tile-major ``_block_step`` with the toy
dual-output model of tests/test_streaming.py and with a small real
``PackedTeraUNet``; ``auto_plan``'s choice off the card and its candidate
walk; ``StreamingGenerator`` tile- and block-major, K = 1, 2, 3, f32 and
bf16 transfers and state, the memmap backend, resume, spills read both
ways, the gene caches, the pipeline and the CLI's ``--stream``.  The JAX
side draws the LCG ``'torch'`` noise, the only one the port has.
"""

import dataclasses
import queue
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import GKW, MKW, gene_grid
from test_torch_io import f32_tree
from test_torch_models import seeded_params

from tera_mind_tpu.data import tilestore as jts
from tera_mind_tpu.diffusion.sampler import DiffusionSampler as JSampler
from tera_mind_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from tera_mind_tpu.diffusion.schedule import spaced_schedule as j_spaced
from tera_mind_tpu.models import unet_packed as jpk
from tera_mind_tpu.models.unet import TeraUNetConfig as JUNetConfig
from tera_mind_tpu.ops.collage import to_collage as j_to_collage
from tera_mind_tpu.parallel import generator as jgen
from tera_mind_tpu.parallel import streaming as jstream
from tera_mind_tpu_torch import convert as tconvert
from tera_mind_tpu_torch.cli import generate as tcli
from tera_mind_tpu_torch.data import tilestore as tts
from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                   SamplerConfig)
from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
from tera_mind_tpu_torch.models.unet import TeraUNetConfig
from tera_mind_tpu_torch.models.unet_packed import make_packed_model
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops.collage import to_collage
from tera_mind_tpu_torch.parallel import generator as tgen
from tera_mind_tpu_torch.parallel import streaming as tstream

TOY_ATOL = 1e-5   # the toy model's f32 sums in another order
UNET_ATOL = 2e-4  # the UNet chains' tolerance (test_torch_generator.py)
# the toy geometry of tests/test_streaming.py: 64 px tiles, 32 px patches,
# 2 stains x 4 slices, 8 genes; 2 z-windows
TOY = dict(tile=64, patch=32, gn_blk=16, snum=4, n_slices=4, stains=2,
           gdim=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test module (see tests/test_torch_packed.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_toy(xp, tm, rp, p1, p2):
    """tests/test_streaming.py's toy model: eps from the patch and its
    gene conditioning, collage decode."""
    g = jnp.mean(rp, axis=(1, 2, 3))
    eps = 0.1 * xp + 0.01 * g[:, None, None, None]
    return j_to_collage(eps[:, None], p1, p2)[:, 0], eps


def t_toy(xp, tm, rp, p1, p2):
    g = rp.mean(dim=(1, 2, 3))
    eps = 0.1 * xp + 0.01 * g[:, None, None, None]
    return to_collage(eps[:, None], p1, p2)[:, 0], eps


def toy_pair(T="ddim3", **over):
    """(JAX generator, port generator) on the toy model and geometry."""
    kw = {**TOY, **over}
    jg = jgen.TeraGenerator(
        JSampler(j_spaced("linear", 1000, T),
                 JSamplerConfig(patch_size=kw["patch"],
                                gn_sz=kw["patch"] // 16)),
        j_toy, jgen.GeneratorConfig(**kw, noise_backend="torch"))
    tg = tgen.TeraGenerator(
        DiffusionSampler(spaced_schedule("linear", 1000, T),
                         SamplerConfig(patch_size=kw["patch"],
                                       gn_sz=kw["patch"] // 16)),
        t_toy, tgen.GeneratorConfig(**kw), device="cpu")
    return jg, tg


def field_gene(conf, rows, cols, seed=5):
    """Per-tile gene bins cut from one field, so neighbours' overlapping
    bins agree (what block-major and K > 1 windows rely on)."""
    nb, hb = conf.tile // conf.gn_blk, conf.pad // conf.gn_blk
    field = (np.random.default_rng(seed).random(
        (rows * nb + 2 * hb, cols * nb + 2 * hb, conf.z_pad, conf.gdim))
        < 0.05).astype(np.uint8)
    return np.stack([np.stack([field[r * nb:r * nb + nb + 2 * hb,
                                     c * nb:c * nb + nb + 2 * hb]
                               for c in range(cols)]) for r in range(rows)])


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def jrun(jg, gene, rows=3, cols=3, **sc):
    return jstream.StreamingGenerator(jg, jstream.StreamConfig(
        block_rows=2, block_cols=2, progress=False, **sc)).run(
        rows, cols, gene, row0=1, col0=1)


def trun(tg, gene, rows=3, cols=3, **sc):
    sgen = tstream.StreamingGenerator(tg, tstream.StreamConfig(
        block_rows=2, block_cols=2, progress=False, **sc))
    return sgen.run(rows, cols, gene, row0=1, col0=1)


# --------------------------------------------------------------------------
# the tile-major step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wc", [0, 1])
def test_tile_major_step_matches_jax_toy(wc):
    """The port's ``_block_step`` (and ``compile_pieces``) against JAX's
    tile-major step on the toy model; per-tile genes that are NOT
    field-consistent, which only the tile-major step allows."""
    jg, tg = toy_pair(window_chunk=wc)
    c = tg.conf
    gene = (np.random.default_rng(1).random(
        (2, 3, c.gsz, c.gsz, c.z_pad, c.gdim)) < 0.05).astype(np.uint8)
    state = tg.init_state(2, 3, row0=1, col0=1)
    want = np.asarray(jg.compile_step(2, 3, block_major=False)(
        jnp.asarray(state), jnp.asarray(gene), jnp.int32(1)))
    s, g = torch.from_numpy(state), torch.from_numpy(gene)
    got = tg.compile_step(2, 3, block_major=False)(s, g, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=TOY_ATOL)
    np.testing.assert_array_equal(tg.compile_pieces()(s, g, 1).numpy(),
                                  got.numpy())


@pytest.fixture(scope="module")
def packed_pair():
    """A small PackedTeraUNet in both packages on one packed tree, and a
    factory of (JAX, port) generators on it."""
    jconf = JUNetConfig(**MKW, dropout=0.0)
    p5 = f32_tree(seeded_params(
        jconf.make_model(), np.zeros((4, 32, 32, 2), np.float32),
        np.zeros((1,), np.int32), np.zeros((4, 2, 2, 24), np.float32), 2, 2))
    pp = jpk.pack_unet_params(p5, jconf)
    jm = jpk.PackedTeraUNet(jconf)
    model = tconvert.load_jax_params(
        make_packed_model(TeraUNetConfig(**MKW)), pp).eval()

    def make(**over):
        kw = {**GKW, **over}
        jg = jgen.TeraGenerator(
            JSampler(j_spaced("linear", 1000, "ddim3"),
                     JSamplerConfig(patch_size=32, gn_sz=2)),
            lambda p, xp, tm, rp, p1, p2: jm.apply(
                p, xp, tm, rp, p1, p2, decode_original=False),
            jgen.GeneratorConfig(**kw, noise_backend="torch"), params=pp)
        tg = tgen.TeraGenerator(
            DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                             SamplerConfig(patch_size=32, gn_sz=2)),
            lambda xp, tm, rp, p1, p2: model(xp, tm, rp, p1, p2,
                                             decode_original=False),
            tgen.GeneratorConfig(**kw), device="cpu")
        return jg, tg
    return make


@pytest.mark.parametrize("wc", [0, 1])
def test_tile_major_step_matches_jax_packed_unet(packed_pair, wc):
    """One tile-major step of the real (small) PackedTeraUNet, port
    against JAX, and against the port's own block-major step."""
    jg, tg = packed_pair(window_chunk=wc)
    gene = gene_grid(tg.conf)
    state = tg.init_state(2, 2, row0=1, col0=1, grid_w=16)
    want = np.asarray(jg.compile_step(2, 2, block_major=False)(
        jnp.asarray(state), jnp.asarray(gene), jnp.int32(2)))
    s, g = torch.from_numpy(state), torch.from_numpy(gene)
    got = tg.compile_step(2, 2, block_major=False)(s, g, 2).numpy()
    np.testing.assert_allclose(got, want, atol=UNET_ATOL)
    np.testing.assert_allclose(
        got, tg.compile_step(2, 2, block_major=True)(s, g, 2).numpy(),
        atol=UNET_ATOL)


def test_unfused_run_is_the_tile_major_chain():
    """``run(fused=False)`` (JAX's ``compile_pieces``) equals the fused
    tile-major run whatever ``block_major`` says, as in JAX."""
    jg, tg = toy_pair(window_chunk=1)
    gene = field_gene(tg.conf, 2, 2)
    want = jg.run(gene, row0=1, col0=1, progress=False, fused=False)
    got = tg.run(gene, row0=1, col0=1, progress=False, fused=False,
                 block_major=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOY_ATOL)
    np.testing.assert_array_equal(
        got, tg.run(gene, row0=1, col0=1, progress=False))


# --------------------------------------------------------------------------
# the memory planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("env", [{}, {"TMT_MAX_PATCHES": "30"},
                                 {"TMT_MAX_PATCHES": "1"},
                                 {"TMT_TARGET_PATCHES": "40",
                                  "TMT_MAX_PATCHES": "200"}])
def test_auto_plan_off_the_card_equals_jax(monkeypatch, env):
    """Off the card both take the first candidate: the same dict for
    every grid shape, at the flagship geometry and a small one."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    geoms = [dict(tile=256, patch=64, gn_blk=16, snum=4, n_slices=50,
                  stains=2, gdim=8), dict(TOY)]
    for geom in geoms:
        for rows, cols in [(1, 1), (2, 2), (4, 2), (3, 5), (8, 8), (16, 16),
                           (6, 4)]:
            jg, tg = toy_pair(**{**geom, "window_chunk": -1})
            want = jg.auto_plan(rows, cols, verbose=False)
            got = tg.auto_plan(rows, cols, verbose=False)
            assert got == want, (geom["tile"], rows, cols, env)
            assert (tg.conf.strip_rows, tg.conf.window_chunk) == \
                (jg.conf.strip_rows, jg.conf.window_chunk)
    # the packed 2x2 main chain plans to its whole block, one z-window a
    # call: (2*4 + 1)^2 = 81 patches, nearest TMT_TARGET_PATCHES
    if not env:
        _, tg = toy_pair(**{**geoms[0], "window_chunk": -1})
        assert tgen.plan_candidates(2, 2, tg.conf)[0] == (False, 0, 1)


def test_plan_walk_skips_oom_and_oversize_candidates():
    """The walk on the card: a probe out of device memory and one over
    the budget are passed over; the next that fits is taken; when none
    fits the last (safest) is taken with need -1; other errors raise."""
    cands = [(False, 0, 1), (False, 2, 1), (False, 1, 1), (True, 0, 5)]
    need = {cands[1]: 90, cands[2]: 60, cands[3]: 10}
    seen = []

    def probe(cand):
        seen.append(cand)
        if cand == cands[0]:
            raise torch.cuda.OutOfMemoryError("probe")
        return need[cand]

    assert tgen.walk_plans(cands, probe, 80, verbose=False) == \
        (cands[2], 60)
    assert seen == cands[:3]
    assert tgen.walk_plans(cands, lambda c: 1000, 80, verbose=False) == \
        (cands[3], -1)
    with pytest.raises(ValueError):
        tgen.walk_plans(cands, lambda c: int("x"), 80, verbose=False)


def test_compile_step_plans_only_the_block_major_step(monkeypatch):
    """``window_chunk`` -1: the block-major step is planned (here to row
    strips), the tile-major one takes chunk 1, as in JAX."""
    _, tg = toy_pair(window_chunk=-1)
    monkeypatch.setenv("TMT_MAX_PATCHES", "15")
    step = tg.compile_step(4, 2, block_major=True)
    monkeypatch.delenv("TMT_MAX_PATCHES")
    assert step == tg._block_major_step
    assert (tg.conf.strip_rows, tg.conf.window_chunk) == (1, 1)
    _, tg = toy_pair(window_chunk=-1)
    assert tg.compile_step(4, 2, block_major=False) == tg._block_step
    assert tg.conf.window_chunk == -1 and tg._wchunk() == 1


# --------------------------------------------------------------------------
# streaming against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block_major", [False, True])
def test_streaming_matches_jax_and_in_memory(block_major):
    """3x3 tiles in 2x2 windows (edge windows shifted inward): the port's
    stream against JAX's, and against its own in-memory run."""
    jg, tg = toy_pair()
    gene = field_gene(tg.conf, 3, 3)
    got = trun(tg, gene, block_major=block_major)
    assert got.read.dtype == torch.float32
    want = jrun(jg, gene, block_major=block_major)
    np.testing.assert_allclose(as_f32(got.read), as_f32(want.read),
                               atol=TOY_ATOL)
    np.testing.assert_allclose(
        as_f32(got.read), tg.run(gene, row0=1, col0=1, progress=False,
                                 block_major=block_major), atol=1e-6)


@pytest.mark.parametrize("k", [2, 3])
def test_multistep_matches_jax_and_single_step(k):
    """K-step visits (T = 3: K = 2 runs visits of 2 then 1 steps) against
    JAX's and against the port's K = 1 sweep."""
    jg, tg = toy_pair()
    gene = field_gene(tg.conf, 3, 3)
    got = as_f32(trun(tg, gene, block_major=True, steps_per_window=k).read)
    want = as_f32(jrun(jg, gene, block_major=True,
                       steps_per_window=k).read)
    np.testing.assert_allclose(got, want, atol=TOY_ATOL)
    np.testing.assert_allclose(
        got, as_f32(trun(tg, gene, block_major=True).read), atol=TOY_ATOL)
    with pytest.raises(ValueError):   # tile 64, patch 32: max K = 3
        tstream.StreamingGenerator(tg, tstream.StreamConfig(
            steps_per_window=4))


def test_window_chunk_auto_resolution_equals_jax():
    """-1 resolves per window shape, exactly as JAX: a 2x2 block-major
    window 5 (405 patches), 4x4 1, tile-major 5."""
    geom = dict(tile=256, patch=64, gn_blk=16, snum=4, n_slices=50,
                stains=2, gdim=8, window_chunk=-1)
    for block, bm, want in [(2, True, 5), (4, True, 1), (2, False, 5),
                            (1, True, 5), (3, True, 1)]:
        got = []
        for gen, mod in zip(toy_pair(**geom), (jstream, tstream)):
            mod.StreamingGenerator(gen, mod.StreamConfig(
                block_rows=block, block_cols=block, block_major=bm,
                progress=False))
            got.append(gen.conf.window_chunk)
        assert got == [want, want], (block, bm, got)


def test_bf16_transfer_and_state_match_jax():
    """bf16 transfers with bf16 state (the default for them) and with an
    f32 master copy: each within one bf16 spacing of JAX's, the two
    bit-equal, and within JAX's own bounds of the f32 sweep (max 0.05,
    mean 5e-3, tests/test_streaming.py)."""
    jg, tg = toy_pair()
    gene = field_gene(tg.conf, 2, 2, seed=17)
    f32 = as_f32(trun(tg, gene, 2, 2).read)
    b16 = trun(tg, gene, 2, 2, transfer_dtype="bfloat16")
    master = trun(tg, gene, 2, 2, transfer_dtype="bfloat16",
                  state_dtype="float32")
    assert b16.read.dtype == torch.bfloat16
    assert master.read.dtype == torch.float32
    np.testing.assert_array_equal(as_f32(b16.read), as_f32(master.read))
    want = as_f32(jrun(jg, gene, 2, 2, transfer_dtype="bfloat16").read)
    got = as_f32(b16.read)
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= spacing).all()
    assert np.abs(got - f32).max() < 0.05
    assert np.abs(got - f32).mean() < 5e-3


def test_bf16_transfer_gap_of_the_small_unet_equals_jax():
    """chip_smoke.py's small packed UNet (random weights, seed 3) on its
    3x3 field-consistent grid: bf16 transfers move the 3-step result by
    a max |d| of 0.0700 (9 of 147,456 values above tests/test_streaming
    .py's toy-model bound 0.05) and a mean of 1.04e-3, in both packages
    alike.  Port and JAX gaps agree within 2e-3 (max) and 1e-4 (mean):
    the f32 runs differ by reassociation (2e-4), which can move a bf16
    rounding by one spacing."""
    import chip_smoke as cs

    from tera_mind_tpu_torch.convert import export_params
    from tera_mind_tpu_torch.models.nn import init_weights
    from tera_mind_tpu_torch.models.unet_packed import pack_unet_params

    mconf, gconf, _ = cs.small_setup()
    model5 = init_weights(mconf.make_model(), seed=3).eval()
    p5 = f32_tree(export_params(model5))
    jconf = JUNetConfig(**{**{f.name: getattr(mconf, f.name)
                              for f in dataclasses.fields(mconf)},
                           "dropout": 0.0})
    jm = jpk.PackedTeraUNet(jconf)
    jg = jgen.TeraGenerator(
        JSampler(j_spaced("linear", 1000, "ddim3"),
                 JSamplerConfig(patch_size=32, gn_sz=2)),
        lambda p, xp, tm, rp, p1, p2: jm.apply(p, xp, tm, rp, p1, p2,
                                               decode_original=False),
        jgen.GeneratorConfig(**dataclasses.asdict(gconf)),
        params=jpk.pack_unet_params(p5, jconf))
    packed = tconvert.load_jax_params(make_packed_model(mconf),
                                      pack_unet_params(p5, mconf)).eval()
    tg = cs.small_gen(packed, torch.device("cpu"), gconf)
    gene = cs.small_field_gene(gconf, 3, 3)
    gaps = []
    for run, gen in ((jrun, jg), (trun, tg)):
        f32, b16 = (as_f32(run(gen, gene, block_major=True,
                               transfer_dtype=dt).read)
                    for dt in ("float32", "bfloat16"))
        gaps.append(np.abs(b16 - f32))
    (jd, td) = gaps
    assert abs(td.max() - jd.max()) <= 2e-3 and \
        abs(td.mean() - jd.mean()) <= 1e-4, (td.max(), jd.max())
    assert jd.max() > 0.05 and jd.mean() < 5e-3, (jd.max(), jd.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memmap_backend_and_sidecar(tmp_path, dtype):
    """Memmapped state gives the in-memory result exactly; its sidecar
    says what JAX's says, and the files hold the state's bits."""
    jg, tg = toy_pair()
    gene = field_gene(tg.conf, 2, 2, seed=1)
    sc = dict(transfer_dtype=dtype)
    want = trun(tg, gene, 2, 2, **sc)
    got = trun(tg, gene, 2, 2, memmap_dir=str(tmp_path / "t"), **sc)
    np.testing.assert_array_equal(as_f32(got.read), as_f32(want.read))
    jstream.HostState(2, 2, 64, tg.conf.channels,
                      memmap_dir=str(tmp_path / "j"),
                      dtype=np.dtype(getattr(jnp, dtype)))
    assert (tmp_path / "t" / "state_dtype.txt").read_text() == \
        (tmp_path / "j" / "state_dtype.txt").read_text()
    raw = np.load(tmp_path / "t" / f"state_{got.read_idx}.npy")
    if dtype == "bfloat16":
        raw, bits = raw.view(np.int16), got.read.view(torch.int16)
    else:
        bits = got.read
    np.testing.assert_array_equal(raw, bits.numpy())


def test_padded_window_matches_jax():
    """Halo, -1 fill, ghost strips and a reused staging buffer that
    casts, against JAX's HostState on the same buffer."""
    rng = np.random.default_rng(4)
    data = rng.standard_normal((12, 8, 3)).astype(np.float32)
    js = jstream.HostState(3, 2, 4, 3)
    ts = tstream.HostState(3, 2, 4, 3)
    js.read[:] = data
    ts.read[:] = torch.from_numpy(data)
    top = rng.standard_normal((5, 8, 3)).astype(np.float32)
    bot = rng.standard_normal((5, 8, 3)).astype(np.float32)
    stage = torch.full((12, 12, 3), 7.0, dtype=torch.bfloat16)
    for args, kw in [((1, 1, 1, 1, 2), {}), ((0, 0, 3, 2, 2), {}),
                     ((0, 0, 2, 2, 3), dict(ghost_top=top)),
                     ((1, 0, 2, 2, 3), dict(ghost_bot=bot))]:
        want = js.padded_window(*args, **kw)
        np.testing.assert_array_equal(
            ts.padded_window(*args, **{k: torch.from_numpy(v)
                                       for k, v in kw.items()}).numpy(),
            want)
    got = ts.padded_window(0, 0, 2, 2, 2, out=stage)
    assert got is stage
    np.testing.assert_array_equal(
        got.float().numpy(),
        js.padded_window(0, 0, 2, 2, 2).astype(jnp.bfloat16)
        .astype(np.float32))


# --------------------------------------------------------------------------
# streaming: caches, pipeline, guards, resume and spills
# --------------------------------------------------------------------------

def counting(gene, calls):
    def provider(r, c):
        calls.append((r, c))
        return gene[r, c]
    return provider


def test_gene_caches():
    """The host LRU bounded to 1 window refetches every window every
    sweep (device cache off; one sequential sweep, since with windows in
    flight a sweep's first window can still find the block the previous
    sweep ended on); the device cache fetches each tile once; both give
    the array-fed result exactly."""
    _, tg = toy_pair()
    gene = field_gene(tg.conf, 2, 6, seed=9)
    want = as_f32(trun(tg, gene, 2, 6).read)
    calls = []
    got = trun(tg, counting(gene, calls), 2, 6, gene_cache_windows=1,
               gene_device_cache_gb=0.0, pipeline=False)
    np.testing.assert_array_equal(as_f32(got.read), want)
    assert len(calls) == 3 * 2 * 6       # T steps x tiles
    calls.clear()
    got = trun(tg, counting(gene, calls), 2, 6, gene_cache_windows=1)
    np.testing.assert_array_equal(as_f32(got.read), want)
    assert len(calls) == 2 * 6           # one fetch per tile, ever
    calls.clear()
    trun(tg, counting(field_gene(tg.conf, 3, 3), calls), block_major=True,
         steps_per_window=3, gene_cache_windows=2)
    assert calls and all(0 <= r < 3 and 0 <= c < 3 for r, c in calls)


def test_pipeline_off_equals_on_and_worker_errors_propagate():
    """Worker threads (pipeline on, 3 in flight) and one sequential sweep
    give the same bits; a provider's error in a worker fails the run."""
    _, tg = toy_pair()
    gene = field_gene(tg.conf, 3, 3, seed=13)
    on = trun(tg, gene, block_major=True, inflight=3)
    off = trun(tg, gene, block_major=True, pipeline=False)
    np.testing.assert_array_equal(as_f32(on.read), as_f32(off.read))
    workers = set()

    def bad(r, c):
        workers.add(threading.current_thread().name)
        if (r, c) == (2, 2):
            raise KeyError("tile (2, 2) missing")
        return gene[r, c]
    with pytest.raises(KeyError, match="missing"):
        trun(tg, bad)
    assert threading.main_thread().name not in workers


def thread_strips(n):
    """StripExchange stand-ins for ``n`` bands run in threads of one
    process: band r's top edge goes to band r - 1, its bottom edge to
    band r + 1, through queues."""
    q = {(a, b): queue.Queue() for a in range(n) for b in (a - 1, a + 1)}

    def make(r):
        def ex(top, bot):
            if r > 0:
                q[(r, r - 1)].put(torch.as_tensor(top).clone())
            if r < n - 1:
                q[(r, r + 1)].put(torch.as_tensor(bot).clone())
            return (q[(r - 1, r)].get(timeout=60) if r > 0 else None,
                    q[(r + 1, r)].get(timeout=60) if r < n - 1 else None)
        return ex
    return [make(r) for r in range(n)]


def run_bands(tg, gene, bands, rows=3, cols=3, **sc):
    """The (rows x cols) grid streamed as row bands ``bands`` ((first row,
    rows) each), one thread a band exchanging strips through queues;
    returns the bands' results stacked."""
    k = sc.get("steps_per_window", 1)
    pad = tg.conf.pad + tg.conf.patch * (k - 1)
    strips = thread_strips(len(bands))
    out = [None] * len(bands)

    def band(i):
        r0, n = bands[i]
        sgen = tstream.StreamingGenerator(tg, tstream.StreamConfig(
            block_rows=2, block_cols=2, progress=False, **sc))
        out[i] = as_f32(sgen.run(
            n, cols, lambda r, c: gene[r0 + r, c], row0=1 + r0, col0=1,
            strip_exchange=strips[i], rows_above=r0,
            rows_below=rows - r0 - n).read)
    threads = [threading.Thread(target=band, args=(i,))
               for i in range(len(bands))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert pad <= min(n for _, n in bands) * tg.conf.tile
    return np.concatenate(out)


def test_timing_breakdown_and_guards(monkeypatch):
    """TMT_STREAM_TIMING keeps a per-phase breakdown of one sequential
    sweep with the same result; an explicit state needs start_t; windows
    swept round-robin over two devices (two CPU replicas) and the grid
    streamed as two bands exchanging edge strips each give the one-device
    result; a band shorter than its ghost strip is refused, as in JAX."""
    _, tg = toy_pair()
    gene = field_gene(tg.conf, 3, 3, seed=2)
    want = as_f32(trun(tg, gene).read)
    monkeypatch.setenv("TMT_STREAM_TIMING", "1")
    sgen = tstream.StreamingGenerator(tg, tstream.StreamConfig(
        progress=False))
    np.testing.assert_array_equal(
        as_f32(sgen.run(3, 3, gene, row0=1, col0=1).read), want)
    assert sgen.timing["n"] == 3 * 4
    assert set(sgen.timing) == {"asm", "h2d", "disp", "queue", "d2h", "n"}
    monkeypatch.delenv("TMT_STREAM_TIMING")
    with pytest.raises(ValueError, match="start_t"):
        sgen.run(3, 3, gene, state=sgen.make_state(3, 3))
    two = tstream.StreamingGenerator(tg, tstream.StreamConfig(
        block_rows=2, block_cols=2, progress=False), devices=["cpu", "cpu"])
    np.testing.assert_array_equal(
        as_f32(two.run(3, 3, gene, row0=1, col0=1).read), want)
    np.testing.assert_allclose(run_bands(tg, gene, [(0, 2), (2, 1)]), want,
                               atol=TOY_ATOL)
    with pytest.raises(ValueError, match="ghost strip"):
        tstream.StreamingGenerator(tg, tstream.StreamConfig(
            progress=False, steps_per_window=3)).run(
            1, 3, gene, strip_exchange=thread_strips(1)[0])


def test_explicit_start_t_resumes_mid_chain():
    """A state one in-memory step in, streamed for the T-1 steps left,
    equals the whole streamed chain (JAX's test_streaming_explicit_start_t
    at 1e-6)."""
    _, tg = toy_pair()
    gene = field_gene(tg.conf, 2, 2, seed=6)
    sgen = tstream.StreamingGenerator(tg, tstream.StreamConfig(
        progress=False))
    full = as_f32(sgen.run(2, 2, gene, row0=1, col0=1).read)
    s = tg.compile_step(2, 2, block_major=False)(
        torch.from_numpy(tg.init_state(2, 2, row0=1, col0=1)),
        torch.from_numpy(gene), 2)
    hs = sgen.make_state(2, 2)
    hs.read[:] = s
    got = sgen.run(2, 2, gene, row0=1, col0=1, state=hs, start_t=2)
    np.testing.assert_allclose(as_f32(got.read), full, atol=1e-6)


def test_checkpoint_cadence_and_spills_read_both_ways(tmp_path):
    """K = 2 visits over T = 5 with a spill every 2 epochs: spills at
    epochs 2 and 4, the newest kept, as in JAX; each package resumes from
    the other's epoch-4 spill (float16) and agrees with its own resume."""
    jg, tg = toy_pair(T="ddim5")
    gene = field_gene(tg.conf, 2, 2, seed=3)
    sc = dict(block_major=True, steps_per_window=2, checkpoint_every=2)
    want = as_f32(trun(tg, gene, 2, 2, block_major=True).read)

    def port_run(base):
        return tstream.StreamingGenerator(tg, tstream.StreamConfig(
            progress=False, **sc)).run(
            2, 2, gene, row0=1, col0=1,
            checkpoint=tts.StateCheckpoint(base, "grid"))

    def jax_run(base):
        return jstream.StreamingGenerator(jg, jstream.StreamConfig(
            progress=False, **sc)).run(
            2, 2, gene, row0=1, col0=1,
            checkpoint=jts.StateCheckpoint(base, "grid"))

    got = port_run(tmp_path / "t")
    np.testing.assert_allclose(as_f32(got.read), want, atol=TOY_ATOL)
    jax_run(tmp_path / "j")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j_4", "t_4"]
    mine, meta = jts.StateCheckpoint(tmp_path / "t", "grid").load_grid(4)
    theirs, jmeta = tts.StateCheckpoint(tmp_path / "j", "grid").load_grid(4)
    del meta["crc32"], jmeta["crc32"]
    assert meta == jmeta
    np.testing.assert_allclose(mine, theirs,
                               atol=TOY_ATOL + np.spacing(np.float16(4.0)))
    for src, dst in (("t_4", "jr_4"), ("j_4", "tr_4")):
        (tmp_path / dst).mkdir()
        for f in (tmp_path / src).iterdir():
            (tmp_path / dst / f.name).write_bytes(f.read_bytes())
    port_resumed = as_f32(port_run(tmp_path / "tr").read)
    jax_resumed = as_f32(jax_run(tmp_path / "jr").read)
    # float16 spills carry ~5e-4 rounding into the last step
    np.testing.assert_allclose(port_resumed, want, atol=5e-3)
    np.testing.assert_allclose(port_resumed, jax_resumed,
                               atol=TOY_ATOL + np.spacing(np.float16(4.0)))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_stream_exports_the_in_memory_tiles_and_resumes(tmp_path,
                                                            monkeypatch):
    """``--stream`` writes the tiles the in-memory run writes (the toy
    model, block-major 2x2 windows on 3x3 tiles), spills every
    ``--ckpt_every`` steps, and ``--cur_epoch`` resumes the streamed run
    from that spill as ``StreamingGenerator.run`` would; without a card
    ``--stream`` refuses to start unless ``--device cpu`` is given."""
    _, tg = toy_pair(window_chunk=1)
    gene = field_gene(tg.conf, 3, 3, seed=8)
    monkeypatch.setattr(tcli, "build", lambda args: (tg, None, gene, (1, 1)))
    base = ["--synthetic", "--hnm", "3", "--wnm", "3", "--hst", "64",
            "--wst", "64", "--tot_epoch", "3", "--ckpt_every", "1",
            "--device", "cpu"]
    mem = tcli.main(base + ["--out_dir", str(tmp_path / "mem")])
    argv = base + ["--stream", "--out_dir", str(tmp_path / "st")]
    out = tcli.main(argv)
    np.testing.assert_allclose(out, mem, atol=1e-6)
    a, b = tts.TileStore(tmp_path / "mem"), tts.TileStore(tmp_path / "st")
    assert a.names() == b.names() and len(a.names()) == 9
    for name in a.names():
        np.testing.assert_allclose(b.read(name).astype(np.float32),
                                   a.read(name).astype(np.float32),
                                   atol=np.spacing(np.float16(4.0)))
    assert len(list((tmp_path / "st" / "preview").glob("*_gen.jpg"))) == 8
    state, _ = tts.StateCheckpoint(tmp_path / "st_state", "grid") \
        .load_grid(2)
    again = tcli.main(argv + ["--cur_epoch", "2"])
    sgen = tcli.make_streamer(tcli.parse_args(argv), tg)
    hs = sgen.make_state(3, 3)
    hs.read[:] = torch.from_numpy(tgen.grid_to_image(state))
    np.testing.assert_array_equal(
        again, as_f32(sgen.run(3, 3, gene, row0=1, col0=1, state=hs,
                               start_t=1).read))
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            tcli.build(tcli.parse_args(["--synthetic", "--stream", "--hnm",
                                        "1", "--wnm", "1"]))


def test_cli_stream_and_tile_major_options():
    """The JAX CLI's defaults: block 2, K 1, f32 transfers, 3 in flight,
    4 GB of gene cache, window_chunk -1; ``--tile_major`` with -1 means
    5; the gene files' LRU holds 4 * (block + 2)^2 tiles."""
    args = tcli.parse_args(["--synthetic"])
    assert (args.stream, args.stream_block, args.stream_k,
            args.stream_memmap, args.stream_inflight, args.stream_gene_gb,
            args.stream_dtype, args.stream_state_dtype, args.tile_major,
            args.window_chunk) == (False, 2, 1, None, 3, 4.0, "float32",
                                   None, False, -1)
    sgen = tcli.make_streamer(args, toy_pair(window_chunk=1)[1])
    assert dataclasses.asdict(sgen.sconf) == dataclasses.asdict(
        tstream.StreamConfig(checkpoint_every=5, block_major=True))
    src = Path(tcli.__file__).read_text()
    assert "maxsize=4 * (args.stream_block + 2) ** 2" in src
    assert "5 if args.tile_major" in src


# --------------------------------------------------------------------------
# the kernels' launch counters
# --------------------------------------------------------------------------

def test_launch_counters_lose_no_increment_across_threads():
    """Eight threads x 1,000 launches through the counter helper that both
    kernel wrappers use: all 8,000 counted, per variant too."""
    class Counters:
        launches = 0
        launches_by_variant = {"a": 0, "b": 0}

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as possible
    try:
        threads = [threading.Thread(target=lambda i=i: [
            _build.count_launch(Counters, "ab"[i % 2]) for _ in range(1000)])
            for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert Counters.launches == 8000
    assert Counters.launches_by_variant == {"a": 4000, "b": 4000}
    _build.reset_launches(Counters)
    assert (Counters.launches, Counters.launches_by_variant) == \
        (0, {"a": 0, "b": 0})

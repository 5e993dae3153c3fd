"""The port's generation I/O against the JAX package's, on the CPU.

Reference checkpoints (``load_torch_state_dict``, ``convert_unet_params``
on a reference-named state dict the test builds), ``config_from_name``,
the gene files (``COO``, ``load_gene_tile``, the per-tile provider),
``TileStore`` and ``StateCheckpoint`` (spills written by one package read
bit-exactly by the other, CRC checked), and the z-packed block-major chain
end to end: 2x2 tiles x 3 DDIM steps against JAX's packed chain, resumed
by both packages from the same spill, fed by a provider, and driven
through the CLI's ``main``.  Chain tolerances as in
test_torch_generator.py.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from test_convert import TINY, _flax_to_torch_sd
from test_torch_generator import GKW, MKW, gene_grid
from test_torch_models import seeded_params

from tera_mind_tpu import config as jconfig
from tera_mind_tpu import convert as jconvert
from tera_mind_tpu.cli import generate as jcli
from tera_mind_tpu.data import coo as jcoo
from tera_mind_tpu.data import tilestore as jts
from tera_mind_tpu.diffusion.sampler import DiffusionSampler as JSampler
from tera_mind_tpu.diffusion.sampler import SamplerConfig as JSamplerConfig
from tera_mind_tpu.diffusion.schedule import spaced_schedule as j_spaced
from tera_mind_tpu.models import unet_packed as jpk
from tera_mind_tpu.models.unet import TeraUNetConfig as JUNetConfig
from tera_mind_tpu.parallel import generator as jgen
from tera_mind_tpu_torch import config as tconfig
from tera_mind_tpu_torch import convert as tconvert
from tera_mind_tpu_torch.cli import generate as tcli
from tera_mind_tpu_torch.data import coo as tcoo
from tera_mind_tpu_torch.data import tilestore as tts
from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                   SamplerConfig)
from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
from tera_mind_tpu_torch.models.unet import TeraUNetConfig
from tera_mind_tpu_torch.models.unet_packed import make_packed_model
from tera_mind_tpu_torch.parallel import generator as tgen


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


def f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def assert_dicts_equal(got, want, prefix=""):
    assert sorted(got) == sorted(want), prefix
    for k in want:
        if isinstance(want[k], dict):
            assert_dicts_equal(got[k], want[k], f"{prefix}/{k}")
        else:
            assert got[k].dtype == want[k].dtype, f"{prefix}/{k}"
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{prefix}/{k}")


# --------------------------------------------------------------------- #
# reference checkpoints and run names                                     #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref_state_dict():
    """A reference-named state dict (test_convert.py's inverse of the
    converter) of a seeded flax tree at the tiny config."""
    p = seeded_params(TINY.make_model(), np.zeros((4, 32, 32, 4), np.float32),
                      np.zeros((1,), np.int32),
                      np.zeros((4, 2, 2, 64), np.float32), 2, 2, seed=1)
    return _flax_to_torch_sd(f32_tree(p), TINY)


def port_tiny_conf():
    kw = {f: getattr(TINY, f) for f in ("image_size", "gn_sz", "rna_num",
                                        "rna_tpl", "in_channels",
                                        "out_channels", "model_channels",
                                        "embed_channels")}
    return TeraUNetConfig(**kw)


def test_convert_unet_params_equals_jax(ref_state_dict):
    sd = ref_state_dict
    got = tconvert.convert_unet_params(sd, port_tiny_conf())
    assert_dicts_equal(got, jconvert.convert_unet_params(sd, TINY))
    # and the tree fills the port's 5D model one for one (strict)
    tconvert.load_jax_params(port_tiny_conf().make_model(), got)


def test_load_torch_state_dict_strips_prefix_and_ema(tmp_path,
                                                     ref_state_dict):
    wrapped = {f"model.{k}": torch.from_numpy(np.ascontiguousarray(v))
               for k, v in ref_state_dict.items()}
    wrapped["ema_model.out.0.weight"] = torch.zeros(1)
    torch.save({"state_dict": wrapped, "epoch": 3}, tmp_path / "last.ckpt")
    got = tconvert.load_torch_state_dict(tmp_path / "last.ckpt")
    assert_dicts_equal(got, jconvert.load_torch_state_dict(
        tmp_path / "last.ckpt"))
    assert_dicts_equal(got, ref_state_dict)
    torch.save(wrapped, tmp_path / "bare.ckpt")          # no "state_dict"
    assert_dicts_equal(tconvert.load_torch_state_dict(tmp_path / "bare.ckpt"),
                       ref_state_dict)


@pytest.mark.parametrize("name", ["638850_64_229_all_4_ours",
                                  "609882_32_500_PolyT_4",
                                  "609889_128_81_DAPI_8_ours"])
def test_config_from_name_matches_jax(name):
    tc, jc = tconfig.config_from_name(name), jconfig.config_from_name(name)
    for f in ("mouse", "image_size", "stain", "rna_num", "rna_slices"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert (tc.in_channels, tc.gn_sz, tc.z_size) == \
        (jc.in_channels, jc.gn_sz, jc.z_size)


def test_config_from_name_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        tconfig.config_from_name("638850_64_229_all_4_sinf")
    with pytest.raises(ValueError):
        tconfig.config_from_name("last")


# --------------------------------------------------------------------- #
# gene files                                                             #
# --------------------------------------------------------------------- #
def rand_coo(rng, shape, nnz):
    coords = np.stack([rng.integers(0, s, nnz) for s in shape])
    return coords, rng.integers(1, 6, nnz).astype(np.int64)


def coo_equal(t, j):
    np.testing.assert_array_equal(t.coords, j.coords)
    np.testing.assert_array_equal(t.data, j.data)
    assert t.data.dtype == j.data.dtype and tuple(t.shape) == tuple(j.shape)


def test_coo_ops_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    coords, data = rand_coo(rng, (40, 36, 12), 500)
    tc = tcoo.COO(coords, data, (40, 36, 12))
    jc = jcoo.COO(coords, data, (40, 36, 12))
    for op, args in (("crop2d", (3, 5, 20, 17)), ("block_sum", (4,)),
                     ("pad_channels", (6, 6)), ("slice_channels", (2, 9)),
                     ("pad_spatial", (3,)), ("rot90", ()), ("flip_w", ())):
        coo_equal(getattr(tc, op)(*args), getattr(jc, op)(*args))
    np.testing.assert_array_equal(tc.todense(), jc.todense())
    dense = tc.todense(np.float64)
    coo_equal(tcoo.COO.from_dense(dense), jcoo.COO.from_dense(dense))
    tc.save_npz(tmp_path / "a.npz")
    coo_equal(tcoo.COO.load_npz(tmp_path / "a.npz"),
              jcoo.COO.load_npz(tmp_path / "a.npz"))


@pytest.fixture(scope="module")
def gene_dir(tmp_path_factory):
    """Reference-named gene files of a 2x2 tile grid at (256, 512): each
    covers its tile and 128 px around it, 50 z-slices x 6 genes."""
    d = tmp_path_factory.mktemp("genes")
    rng = np.random.default_rng(1)
    for r in range(2):
        for c in range(2):
            coords, data = rand_coo(rng, (512, 512, 50 * 6), 3000)
            name = tcli.gene_tile_name(256 + 256 * r, 512 + 256 * c)
            tcoo.COO(coords, data, (512, 512, 300)).save_npz(d / name)
    return d


def test_gene_tiles_and_provider_equal_jax(gene_dir):
    """The port's loader and the JAX CLI's give the same stack, and the
    provider reads the files the JAX CLI names (cli/generate.py:302-314)."""
    prov = tcli.gene_provider(gene_dir, 256, 512, gdim=6, spad=1)
    for r in range(2):
        for c in range(2):
            h0, w0 = 256 + r * 256, 512 + c * 256
            jname = (f"{h0}_{h0+256}_{w0}_{w0+256}_"
                     f"{h0-128}_{h0+384}_{w0-128}_{w0+384}.npz")
            want = jcli.load_gene_tile(gene_dir / jname, gblk=16, gdim=6,
                                       spad=1)
            got = prov(r, c)
            assert got.shape == (20, 20, 52, 6) and got.any()
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tcli.load_gene_tile(gene_dir / tcli.gene_tile_name(256, 512),
                            gblk=16, gdim=6, spad=0),
        jcli.load_gene_tile(gene_dir / tcli.gene_tile_name(256, 512),
                            gblk=16, gdim=6, spad=0))


# --------------------------------------------------------------------- #
# tile store and state spills                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", ["npy", "grid"])
def test_state_checkpoint_interoperates_with_jax(tmp_path, fmt):
    """A spill written by either package loads bit-exactly in the other,
    with identical manifests and CRC32s; a corrupted file raises."""
    state = np.random.default_rng(2).standard_normal(
        (2, 3, 8, 8, 5)).astype(np.float32)
    for writer, reader, tag in ((jts, tts, "j"), (tts, jts, "t")):
        writer.StateCheckpoint(tmp_path / tag, fmt).save_grid(
            4, state, hst=256, wst=512, size=8)
        got, meta = reader.StateCheckpoint(tmp_path / tag, fmt).load_grid(4)
        np.testing.assert_array_equal(got, state.astype(np.float16)
                                      .astype(np.float32))
        assert got.dtype == np.float32
    for name in ("manifest.json",) + (("state.npy",) if fmt == "grid" else
                                      ("256_264_520_528.npy",)):
        a = (tmp_path / "j_4" / name).read_bytes()
        assert a == (tmp_path / "t_4" / name).read_bytes(), name
    # corrupt one stored value: the port's loader refuses the spill
    victim = tmp_path / "t_4" / ("state.npy" if fmt == "grid"
                                 else "256_264_520_528.npy")
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0x40
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupted"):
        tts.StateCheckpoint(tmp_path / "t", fmt).load_grid(4)
    tts.StateCheckpoint(tmp_path / "t", fmt).load_grid(4, verify=False)


def test_state_checkpoint_latest_and_prune(tmp_path):
    ck = tts.StateCheckpoint(tmp_path / "run_state", "grid")
    assert ck.latest() is None
    state = np.zeros((1, 1, 4, 4, 2), np.float32)
    for t in (1, 5, 3):
        ck.save_grid(t, state, hst=0, wst=0, size=4)
    (tmp_path / "run_state_9").mkdir()        # no manifest: incomplete
    assert ck.latest() == 5
    ck.prune(keep_t=5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run_state_5"]


def test_tile_store_and_unported_formats(tmp_path):
    store = tts.TileStore(tmp_path / "tiles").create()
    a = np.arange(24, dtype=np.float16).reshape(2, 3, 4)
    store.write(tts.tile_name(0, 256, 512, 768), a)
    assert store.names() == ["0_256_512_768"] and store.has("0_256_512_768")
    np.testing.assert_array_equal(store.read("0_256_512_768"), a)
    np.testing.assert_array_equal(
        jts.TileStore(tmp_path / "tiles").read("0_256_512_768"), a)
    store.delete()
    assert not store.exists()
    with pytest.raises(NotImplementedError):
        tts.TileStore(tmp_path, "tensorstore")
    with pytest.raises(NotImplementedError):
        tts.StateCheckpoint(tmp_path / "x", "tensorstore")
    with pytest.raises(ValueError):
        tts.StateCheckpoint(tmp_path / "x", "zarr")


# --------------------------------------------------------------------- #
# the packed chain, resume and the CLI                                   #
# --------------------------------------------------------------------- #
class KeepAll(jts.StateCheckpoint):
    """JAX's spill, every epoch kept (so epoch 1's survives the run)."""

    def prune(self, keep_t):
        pass


@pytest.fixture(scope="module")
def packed_chain(tmp_path_factory):
    """JAX's packed block-major 3-step chain with a spill every step, and
    JAX resumed from its epoch-1 spill; a factory of port generators on
    the same packed tree."""
    tmp = tmp_path_factory.mktemp("chain")
    gconf = jgen.GeneratorConfig(**GKW, noise_backend="torch")
    jconf = JUNetConfig(**MKW, dropout=0.0)
    p5 = f32_tree(seeded_params(
        jconf.make_model(), np.zeros((4, 32, 32, 2), np.float32),
        np.zeros((1,), np.int32), np.zeros((4, 2, 2, 24), np.float32), 2, 2))
    pp = jpk.pack_unet_params(p5, jconf)
    jm = jpk.PackedTeraUNet(jconf)
    jg = jgen.TeraGenerator(
        JSampler(j_spaced("linear", 1000, "ddim3"),
                 JSamplerConfig(patch_size=32, gn_sz=2)),
        lambda p, xp, tm, rp, p1, p2: jm.apply(p, xp, tm, rp, p1, p2,
                                               decode_original=False),
        gconf, params=pp)
    gene = gene_grid(gconf)
    run = dict(row0=1, col0=1, grid_w=16, block_major=True, progress=False)
    want = jg.run(gene, checkpoint=KeepAll(tmp / "j", "grid"),
                  checkpoint_every=1, **run)
    shutil.copytree(tmp / "j_1", tmp / "spill_1")
    resumed = jg.run(gene, checkpoint=jts.StateCheckpoint(tmp / "spill",
                                                          "grid"), **run)

    model = tconvert.load_jax_params(
        make_packed_model(TeraUNetConfig(**MKW)), pp)

    def port(**over):
        sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                                   SamplerConfig(patch_size=32, gn_sz=2))
        return tgen.TeraGenerator(
            sampler,
            lambda xp, tm, rp, p1, p2: model(xp, tm, rp, p1, p2,
                                             decode_original=False),
            tgen.GeneratorConfig(**{**GKW, **over}), device="cpu")

    return tmp, gene, np.asarray(want), np.asarray(resumed), port


def test_packed_chain_matches_jax(packed_chain):
    """The slice end to end on the packed model: 2x2 tiles x 3 steps,
    2e-4 absolute as the 5D chain (test_torch_generator.py)."""
    _, gene, want, _, port = packed_chain
    got = port().run(gene, row0=1, col0=1, grid_w=16, block_major=True,
                     progress=False)
    assert got.shape == want.shape == (128, 128, 4)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_resume_from_a_spill_matches_jax(packed_chain):
    """Both packages resume from the same epoch-1 spill (float16) and run
    the last two steps: they agree within the chain tolerance."""
    tmp, gene, _, resumed, port = packed_chain
    shutil.copytree(tmp / "j_1", tmp / "port_1")
    got = port().run(gene, row0=1, col0=1, grid_w=16, block_major=True,
                     progress=False,
                     checkpoint=tts.StateCheckpoint(tmp / "port", "grid"))
    np.testing.assert_allclose(got, resumed, atol=2e-4, rtol=1e-3)


def test_port_spills_match_jax_and_provider_feeds_the_same_chain(
        packed_chain, tmp_path):
    """The port's run spills every step through StateCheckpoint('grid')
    and keeps only the newest spill, which JAX's loader reads (CRC
    checked) and which agrees with JAX's epoch-2 spill within the chain
    tolerance plus one float16 rounding; a provider-fed run gives the
    array-fed result exactly."""
    tmp, gene, _, _, port = packed_chain
    got = port().run(gene, row0=1, col0=1, grid_w=16, block_major=True,
                     progress=False,
                     checkpoint=tts.StateCheckpoint(tmp_path / "s", "grid"),
                     checkpoint_every=1)
    assert [p.name for p in tmp_path.iterdir()] == ["s_2"]
    mine, meta = jts.StateCheckpoint(tmp_path / "s", "grid").load_grid(2)
    theirs, jmeta = jts.StateCheckpoint(tmp / "j", "grid").load_grid(2)
    del meta["crc32"], jmeta["crc32"]
    assert meta == jmeta
    np.testing.assert_allclose(mine, theirs, rtol=1e-3,
                               atol=2e-4 + np.spacing(np.float16(4.0)))
    fed = port().run(lambda r, c: gene[r, c], rows=2, cols=2, row0=1,
                     col0=1, grid_w=16, block_major=True, progress=False)
    np.testing.assert_array_equal(fed, got)
    with pytest.raises(ValueError):
        port().run(lambda r, c: gene[r, c], progress=False)


def test_cli_exports_tiles_and_resumes(packed_chain, tmp_path, monkeypatch):
    """``main``: the final tiles land in --out_dir as float16 named by
    their pixel box, the state is spilled every --ckpt_every steps, and
    --cur_epoch resumes from that epoch's spill exactly as ``run`` would
    from its state."""
    _, gene, _, _, port = packed_chain
    gen = port()
    monkeypatch.setattr(tcli, "build",
                        lambda args: (gen, None, gene, (1, 1)))
    out_dir = tmp_path / "out"
    argv = ["--synthetic", "--hnm", "2", "--wnm", "2", "--hst", "64",
            "--wst", "64", "--tot_epoch", "3", "--ckpt_every", "1",
            "--out_dir", str(out_dir), "--device", "cpu"]
    out = tcli.main(argv)
    store = tts.TileStore(out_dir)
    assert store.names() == ["128_192_128_192", "128_192_64_128",
                             "64_128_128_192", "64_128_64_128"]
    tile = store.read("64_128_128_192")
    assert tile.dtype == np.float16
    np.testing.assert_array_equal(tile, out[:64, 64:].astype(np.float16))
    assert len(list((out_dir / "preview").glob("*_gen.jpg"))) == 4
    spill = tmp_path / "out_state_2"
    assert json.loads((spill / "manifest.json").read_text())["t"] == 2
    state, _ = tts.StateCheckpoint(tmp_path / "out_state", "grid") \
        .load_grid(2)
    again = tcli.main(argv + ["--cur_epoch", "2"])
    np.testing.assert_array_equal(again, gen.run(
        gene, row0=1, col0=1, grid_w=16, block_major=True, progress=False,
        state=tgen.grid_to_image(state), start_t=1))


@pytest.mark.parametrize("stains,stain", [(2, "all"), (1, "PolyT")])
def test_save_preview_writes_the_jax_clis_files(tmp_path, stains, stain):
    out = np.random.default_rng(6).uniform(
        -1.2, 1.2, (24, 16, stains * 3 * 2)).astype(np.float32)
    tcli.save_preview(out, tmp_path / "t", stain, stains, 3, 2)
    jcli.save_preview(out, tmp_path / "j", stain, stains, 3, 2)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == stains * 6
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    tcli.save_preview(out, tmp_path / "wide", stain, stains, 3, 2, max_px=8)
    assert not any((tmp_path / "wide").iterdir())


def test_cli_args_and_model_switch():
    args = tcli.parse_args(["--synthetic", "--hnm", "2", "--wnm", "2"])
    assert (args.no_packed, args.packed_attn, args.ckpt_every,
            args.cur_epoch, args.out_dir) == (False, False, 5, None,
                                              "./output_tiles")
    with pytest.raises(SystemExit):
        tcli.build(tcli.parse_args(["--ckpt_pth", "runs/x_ours"]))
    # random init: the packed model is the 5D one's weights packed, so the
    # two compute the same prediction (f32, reassociation only)
    conf = TeraUNetConfig(**MKW, use_zero_module=False)
    m5 = tcli.make_model(conf, seed=3, packed=False)
    mp = tcli.make_model(conf, seed=3, packed=True, packed_attn=True)
    assert type(mp).__name__ == "PackedTeraUNet" and mp.packed_attn
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((9, 32, 32, 2), np.float32))
    rna = torch.from_numpy(rng.integers(0, 3, (9, 2, 2, 24)).astype(
        np.float32))
    ts = torch.tensor([700])
    with torch.no_grad():
        want, _ = m5(x, ts, rna, 3, 3, decode_original=False)
        got, _ = mp(x, ts, rna, 3, 3, decode_original=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_grid_image_round_trip():
    grid = np.random.default_rng(5).standard_normal((2, 3, 4, 4, 2))
    img = tgen.grid_to_image(grid)
    assert img.shape == (8, 12, 2)
    np.testing.assert_array_equal(img[4:8, 8:12], grid[1, 2])
    np.testing.assert_array_equal(tgen.image_to_grid(img, 4), grid)

"""The port's training inputs against the JAX package's, on the CPU.

Datasets (``SyntheticDataset``, ``MerfishTrainDataset`` on ``.npz`` gene
and ``.npy`` image fixtures written here, ``compact`` on and off), the
batch iterators (one thread, spawned workers), manifests, the train
config's ``config.json`` both ways, the timestep resampler, the
training schedule's ``q_sample``, ResBlock dropout, ``epoch_batches`` and
``Trainer.shape_batch``: bit-equal where the arithmetic is the same,
else at the stated tolerance.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tera_mind_tpu import config as jconfig
from tera_mind_tpu.data import dataset as jds
from tera_mind_tpu.data import manifest as jman
from tera_mind_tpu.data.coo import COO as JCOO
from tera_mind_tpu.diffusion import resample as jres
from tera_mind_tpu.diffusion import schedule as jsched
from tera_mind_tpu_torch import config as tconfig
from tera_mind_tpu_torch.cli import train as tcli
from tera_mind_tpu_torch.data import dataset as tds
from tera_mind_tpu_torch.data import manifest as tman
from tera_mind_tpu_torch.diffusion import resample as tres
from tera_mind_tpu_torch.diffusion import schedule as tsched
from tera_mind_tpu_torch.models import blocks as tblocks
from tera_mind_tpu_torch.models import nn as tnn
from tera_mind_tpu_torch.training import harness as th

# the JAX config's host prefetch depth: the port's loader has its own
NOT_PORTED = {"prefetch_depth"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (see tests/test_torch_packed.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_samples_equal(got, want):
    assert got.image.dtype == want.image.dtype
    assert got.rna.dtype == want.rna.dtype
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.rna, want.rna)


@pytest.mark.parametrize("stain,snum", [("all", 4), ("DAPI", 8)])
def test_synthetic_dataset_is_bit_equal(stain, snum):
    kw = dict(n=5, crop=64, gdim=6, snum=snum, stain=stain, pad_bins=1,
              seed=3)
    port, ref = tds.SyntheticDataset(**kw), jds.SyntheticDataset(**kw)
    assert len(port) == len(ref) == 5
    for got, want in zip(port, ref):
        assert_samples_equal(got, want)


def _merfish_fixture(root, n_tiles=2, size=80, gdim=6, dtype=np.uint8):
    """Per-tile sparse gene files (H, W, 50*G) and (100, H, W) images,
    named by the reference's gene -> img convention."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n_tiles):
        gdir = root / "gene_638850"
        gdir.mkdir(parents=True, exist_ok=True)
        dense = ((rng.random((size, size, 50 * gdim)) < 0.002)
                 * rng.integers(1, 4, (size, size, 50 * gdim)))
        path = gdir / f"{i * size}_{(i + 1) * size}_0_{size}.npz"
        JCOO.from_dense(dense.astype(np.int32)).save_npz(path)
        idir = root / "img_638850"
        idir.mkdir(exist_ok=True)
        img = rng.integers(0, 256, (100, size, size))
        np.save(idir / path.name.replace(".npz", ".npy"),
                img.astype(dtype))
        paths.append(path)
    return paths


@pytest.mark.parametrize("compact", [False, True])
def test_merfish_dataset_is_bit_equal(tmp_path, compact):
    paths = _merfish_fixture(tmp_path)
    kw = dict(gdim=6, gblk=16, crop=32, snum=4, stain="all", pad_bins=1,
              repeat=2, seed=7, compact=compact)
    port, ref = tds.MerfishTrainDataset(paths, **kw), \
        jds.MerfishTrainDataset(paths, **kw)
    assert len(port) == len(ref) == 4
    samples = list(port)
    for got, want in zip(samples, ref):
        assert_samples_equal(got, want)
    assert samples[0].image.dtype == (np.uint8 if compact else np.float32)
    assert samples[0].rna.dtype == (np.uint16 if compact else np.float32)
    if compact:   # the device decode equals the host's float path
        img, rna = th.decode_batch(torch.from_numpy(samples[0].image),
                                   torch.from_numpy(samples[0].rna))
        want = samples[0].image * np.float32(1.0 / 127.5) - np.float32(1.0)
        np.testing.assert_array_equal(img.numpy(), want)
        assert rna.dtype == torch.float32


def test_zarr_images_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="tensorstore"):
        tds.load_tile_image(tmp_path / "x.zip")
    with pytest.raises(ValueError):
        tds.MerfishTrainDataset([], snum=3)


def test_batches_thread_and_workers(tmp_path):
    """The background-thread iterator yields JAX's batches; two spawned
    worker processes yield the same batches, in the pass's order whichever
    worker finishes first."""
    ds = tds.SyntheticDataset(n=7, crop=32, gdim=4, snum=4, pad_bins=1)
    jd = jds.SyntheticDataset(n=7, crop=32, gdim=4, snum=4, pad_bins=1)
    got, want = list(tds.batches(ds, 3)), list(jds.batches(jd, 3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("image", "rna"):
            np.testing.assert_array_equal(g[k], w[k])
    assert len(list(tds.batches(ds, 3, drop_last=False))) == 3
    mp = list(tds.batches(ds, 2, workers=2, drop_last=False))
    assert [len(b["image"]) for b in mp] == [2, 2, 2, 1]
    images = np.concatenate([b["image"] for b in mp])
    np.testing.assert_array_equal(images, np.stack([s.image for s in ds]))


def test_epoch_batches_raises_on_a_short_pass():
    ds = tds.SyntheticDataset(n=3, crop=32, gdim=4, snum=4, pad_bins=1)
    it = tcli.epoch_batches(ds, 2)
    assert next(it)["image"].shape[0] == 2
    assert next(it)["image"].shape[0] == 2      # the next pass
    with pytest.raises(RuntimeError, match="no effective batch"):
        next(tcli.epoch_batches(ds, 4))


def test_shape_batch_clamps_and_warns():
    conf = tconfig.TrainConfig(image_size=32, net_ch=8, embed_channels=32,
                               rna_num=4, compute_dtype="float32",
                               accum_batches=2, dropout=0.0)
    tr = th.Trainer(conf, device="cpu")
    b = {"image": np.zeros((5, 4, 4, 4), np.float32),
         "rna": np.zeros((5, 2, 2, 16), np.float32)}
    with pytest.warns(UserWarning, match="dropping 1 sample"):
        out = tr.shape_batch(b)
    assert out["image"].shape == (2, 2, 4, 4, 4)
    assert out["rna"].shape == (2, 2, 2, 2, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        one = tr.shape_batch({k: v[:1] for k, v in b.items()})
    assert one["image"].shape == (1, 1, 4, 4, 4)


@pytest.mark.parametrize("kw", [dict(), dict(net_ch=16, batch=8),
                                dict(mouse="609882", stain="PolyT",
                                     srna=8, size=32)])
def test_config_json_round_trips_both_ways(tmp_path, kw):
    kw = dict(kw)
    mouse = kw.pop("mouse", "638850")
    tc, jc = tconfig.prep_config(mouse, **{k: v for k, v in kw.items()
                                           if k != "net_ch"}), \
        jconfig.prep_config(mouse, **{k: v for k, v in kw.items()
                                      if k != "net_ch"})
    tc.net_ch = jc.net_ch = kw.get("net_ch", 64)
    assert tc.as_dict() == {k: v for k, v in jc.as_dict().items()
                            if k not in NOT_PORTED}
    assert (tc.logdir, tc.batch_size_effective) == \
        (jc.logdir, jc.batch_size_effective)
    tc.save(tmp_path / "t.json")
    jc.save(tmp_path / "j.json")
    assert jconfig.TrainConfig.load(tmp_path / "t.json") == jc
    assert tconfig.TrainConfig.load(tmp_path / "j.json") == tc
    ts, js = tc.make_train_sampler(), jc.make_train_sampler()
    assert ts.conf.loss_type == js.conf.loss_type
    np.testing.assert_array_equal(
        ts.schedule.sqrt_alphas_cumprod.numpy(),
        np.asarray(js.schedule.sqrt_alphas_cumprod))


def test_config_refuses_what_is_not_ported():
    """The baselines are ported: ``make_model_conf`` gives their configs,
    as JAX's does.  What JAX cannot run, the flagship model with
    ``use_pos`` (its TimeEmbed asserts a position embedding that no caller
    passes), is accepted as a config and refused when the model is built
    (tests/test_torch_baselines.py shows JAX's failure)."""
    mc = tconfig.TrainConfig(method="patch-dm").make_model_conf()
    assert type(mc).__name__ == "PatchDMUNetConfig" and mc.use_pos
    assert type(tconfig.TrainConfig(method="sinf").make_model_conf()
                ).__name__ == "SinfNetConfig"
    with pytest.raises(ValueError, match="use_pos"):
        tconfig.TrainConfig(use_pos=True).make_model_conf().make_model()
    assert tconfig.prep_config("638850", batch=100).accum_batches == 1


def test_manifests_equal_jax(tmp_path):
    root = tmp_path / "data"
    for mouse in ("609882", "609889"):
        for r, c in ((0, 0), (0, 1), (1, 0)):
            g = root / f"gene_{mouse}" / f"{r * 512}_{r * 512 + 512}_" \
                f"{c * 512}_{c * 512 + 512}.npz"
            g.parent.mkdir(parents=True, exist_ok=True)
            g.write_bytes(b"")
            if (r, c) != (1, 0):
                i = g.parent.parent / f"img_{mouse}" / g.name.replace(
                    ".npz", ".npy")
                i.parent.mkdir(parents=True, exist_ok=True)
                i.write_bytes(b"")
        for out, mod in ((tmp_path / "t", tman), (tmp_path / "j", jman)):
            out.mkdir(exist_ok=True)
            assert mod.prep_manifest(root, mouse, out / f"{mouse}.csv",
                                     rows=2, cols=2) == 2
    for mouse in ("609882", "609889", "638850"):
        assert tman.train_paths_for_mouse(tmp_path / "t", mouse) == \
            jman.train_paths_for_mouse(tmp_path / "j", mouse)
    assert [str(p) for p in tman.tile_grid_paths(root, "609882", rows=2,
                                                 cols=3)] == \
        [str(p) for p in jman.tile_grid_paths(root, "609882", rows=2,
                                              cols=3)]
    (tmp_path / "bad.csv").write_text("x\n")
    with pytest.raises(ValueError):
        tman.load_manifest(tmp_path / "bad.csv")


def test_loss_second_moment_resampler_equals_jax():
    rng = np.random.default_rng(4)
    port, ref = tres.LossSecondMomentResampler(6, history=3), \
        jres.LossSecondMomentResampler(6, history=3)
    np.testing.assert_array_equal(port.weights(), ref.weights())
    for _ in range(20):
        ts, losses = rng.integers(0, 6, 8), rng.random(8)
        port.update(ts, losses)
        ref.update(ts, losses)
        np.testing.assert_array_equal(port.weights(), ref.weights())
    assert port._warmed_up() and ref._warmed_up()
    g = torch.Generator().manual_seed(0)
    t, w = port.sample(g, 16)
    assert t.shape == w.shape == (16,) and w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), 1.0 / (6 * port.weights()[t]),
                               rtol=1e-6)
    t, w = tres.UniformSampler(10).sample(g, 1000)
    assert int(t.min()) == 0 and int(t.max()) == 9
    assert torch.equal(w, torch.ones(1000))


def test_q_sample_and_train_schedule_match_jax():
    ts, js = tsched.train_schedule("linear", 1000), \
        jsched.train_schedule("linear", 1000)
    for f in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
              "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    rng = np.random.default_rng(8)
    x0 = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = np.array([0, 517, 999])
    got = ts.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                      torch.from_numpy(noise))
    want = js.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_dropout_rate_scaling_and_generator():
    """flax Dropout semantics: the kept share is 1 - p within 1 % of p over
    10^6 draws, kept values are scaled by 1 / (1 - p), the same seed gives
    the same mask, and a ResBlock applies it only in training mode and
    only with a generator."""
    p = 0.1
    x = torch.ones(1000, 1000)
    y = tnn.dropout(x, p, torch.Generator().manual_seed(0))
    dropped = float((y == 0).float().mean())
    assert abs(dropped - p) <= 0.01 * p
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - p)))
    assert torch.equal(y, tnn.dropout(x, p, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, tnn.dropout(x, p,
                                          torch.Generator().manual_seed(1)))
    yb = tnn.dropout(x.bfloat16(), p, torch.Generator().manual_seed(0))
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, y != 0)

    blk = tblocks.ResBlock3D(8, 8, 16, dropout=0.5)
    tnn.init_weights(blk, seed=1)
    with torch.no_grad():
        blk.out_conv.weight.normal_(generator=torch.Generator()
                                    .manual_seed(2))
    h = torch.randn(2, 2, 4, 4, 8, generator=torch.Generator().manual_seed(3))
    emb = torch.randn(2, 16)
    ref = blk.eval()(h, emb)
    assert torch.equal(blk(h, emb, generator=torch.Generator()), ref)
    blk.train()
    assert torch.equal(blk(h, emb), ref)          # no generator: no dropout
    a = blk(h, emb, generator=torch.Generator().manual_seed(4))
    b = blk(h, emb, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, ref)


def test_train_config_fields_are_the_jax_fields():
    names = [f.name for f in dataclasses.fields(tconfig.TrainConfig)]
    assert names == [f.name for f in dataclasses.fields(jconfig.TrainConfig)
                     if f.name not in NOT_PORTED]

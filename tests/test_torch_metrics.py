"""The port's metrics package and ``cli.evaluate`` against the JAX
package's, on the CPU.

PSNR / SSIM / MS-SSIM within 1e-5 (PSNR 1e-5 relative); the numpy modules
(``stats``, ``fid``, ``PoolFeatures``, the moment collection, gene tables,
classical morphology) equal to JAX's on the same inputs; InceptionV3
against JAX's module on the weights of a live torch replica (both pooling
variants, tests/test_inception.py's tolerance) and ``InceptionFeatures``
against ``FlaxInceptionFeatures`` on one traced export, at inputs below
and above 299 px (the antialiased resize); ``TorchscriptFeatures``; CLIP
refused without transformers; and the evaluation report against JAX's on
the same two tile stores (same keys, values within 1e-5 relative).
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from inception_torch_replica import build_torch_inception

from tera_mind_tpu.cli import evaluate as jeval
from tera_mind_tpu.metrics import features as jfeat
from tera_mind_tpu.metrics import fid as jfid
from tera_mind_tpu.metrics import gene_stats as jgs
from tera_mind_tpu.metrics import inception as jinc
from tera_mind_tpu.metrics import morphology as jmorph
from tera_mind_tpu.metrics import stats as jstats
from tera_mind_tpu_torch.cli import evaluate as teval
from tera_mind_tpu_torch.data.tilestore import TileStore
from tera_mind_tpu_torch.metrics import features as tfeat
from tera_mind_tpu_torch.metrics import fid as tfid
from tera_mind_tpu_torch.metrics import gene_stats as tgs
from tera_mind_tpu_torch.metrics import inception as tinc
from tera_mind_tpu_torch.metrics import morphology as tmorph
from tera_mind_tpu_torch.metrics import stats as tstats

# the packages' __init__ rebinds the name ``ssim`` to the function
jssim = importlib.import_module("tera_mind_tpu.metrics.ssim")
tssim = importlib.import_module("tera_mind_tpu_torch.metrics.ssim")

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread (several pytest workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image_pair(shape, seed):
    """An image in [-1, 1] and a noisy copy of it."""
    rng = np.random.default_rng(seed)
    a = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(shape), -1, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(2, 176, 176, 1), (3, 64, 64, 2)])
def test_psnr_ssim_ms_ssim_match_jax(shape):
    a, b = image_pair(shape, shape[0])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tssim.psnr(ta, tb).numpy(),
                               np.asarray(jssim.psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(tssim.ssim(ta, tb).numpy(),
                               np.asarray(jssim.ssim(a, b)), atol=1e-5,
                               rtol=0)
    for got, want in zip(tssim.ssim(ta, tb, full=True),
                         jssim.ssim(a, b, full=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    if min(shape[1:3]) >= 176:
        np.testing.assert_allclose(tssim.ms_ssim(ta, tb).numpy(),
                                   np.asarray(jssim.ms_ssim(a, b)),
                                   atol=1e-5, rtol=0)
    # a mean of four: one rounding apart at most
    np.testing.assert_allclose(
        tssim._downsample(ta).numpy(), np.asarray(jssim._downsample(a)),
        atol=1e-7, rtol=1e-6)
    assert tssim.MS_WEIGHTS == jssim.MS_WEIGHTS


def test_online_variance_equals_jax():
    """Batches with and without a mask, an empty batch and a 1-D row."""
    t, j = tstats.OnlineVariance(5), jstats.OnlineVariance(5)
    rng = np.random.default_rng(1)
    for i in range(5):
        batch = rng.standard_normal((6, 5)) if i != 3 else np.zeros((0, 5))
        mask = (rng.random((6, 5)) < 0.5) if i == 2 else None
        if i == 4:
            batch = batch[0]
        for ov in (t, j):
            ov.update(batch, mask)
    for key in ("n", "mean", "m2", "variance", "std"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))


def test_streaming_moments_and_frechet_equal_jax():
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((9, 6)) for _ in range(3)]
    mask = rng.random(9) < 0.7
    parts = []
    for mod in (tfid, jfid):
        a, b = mod.StreamingMoments(6), mod.StreamingMoments(6)
        a.add(feats[0], mask)
        a.add(feats[1])
        b.add(feats[2] + 0.5)
        b.add(np.zeros((0, 6)))
        c = mod.StreamingMoments(6).merge(a)
        parts.append((a.finalize(), a.finalize(ddof=0), c.finalize(),
                      mod.d_fid_from_moments(a, b),
                      mod.frechet_distance(*a.finalize(), *b.finalize())))
    (ta, ta0, tc, tdf, tfr), (ja, ja0, jc, jdf, jfr) = parts
    for got, want in ((ta, ja), (ta0, ja0), (tc, jc)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tdf == jdf and tfr == jfr and tdf > 0


def blobs(rng, n, size=64, intensity=1.0):
    """Gaussian blobs in [0, 1] (tests/test_features.py's tiles)."""
    tiles = []
    y, x = np.mgrid[0:size, 0:size]
    for _ in range(n):
        img = np.zeros((size, size), np.float32)
        for _ in range(5):
            cy, cx = rng.integers(8, size - 8, 2)
            img += intensity * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 18)
        tiles.append(np.clip(img, 0, 1).astype(np.float32))
    return tiles


def test_pool_features_and_moment_collection_equal_jax():
    rng = np.random.default_rng(3)
    a = blobs(rng, 20) + [np.zeros((64, 64), np.float32)] * 3
    b = blobs(rng, 20, intensity=0.4)
    rgb = np.stack(blobs(rng, 4)).reshape(4, 64, 64, 1).repeat(3, -1)
    for grid in (4, 8):
        np.testing.assert_array_equal(tfeat.PoolFeatures(grid)(rgb),
                                      jfeat.PoolFeatures(grid)(rgb))
    ex_t, ex_j = tfeat.PoolFeatures(4), jfeat.PoolFeatures(4)
    keep = lambda t: t.sum() > 0   # noqa: E731
    mt = tfeat.collect_moments(iter(a), ex_t, mask_fn=keep, batch=6)
    mj = jfeat.collect_moments(iter(a), ex_j, mask_fn=keep, batch=6)
    assert mt.n == mj.n == 20
    np.testing.assert_array_equal(mt.s1, mj.s1)
    np.testing.assert_array_equal(mt.s2, mj.s2)
    assert tfeat.d_fid_between_stores(iter(a[:20]), iter(b)) == \
        jfeat.d_fid_between_stores(iter(a[:20]), iter(b))
    slices = {0: a[:10], 1: a[10:20]}
    got = tfeat.d_fid_per_slice(lambda s: iter(slices[s]),
                                lambda s: iter(b[s::2]), [0, 1], ex_t)
    want = jfeat.d_fid_per_slice(lambda s: iter(slices[s]),
                                 lambda s: iter(b[s::2]), [0, 1], ex_j)
    assert got == want


def gene_provider(r, c):
    """A (4, 4, 2, 6) gene stack per tile; tile (1, 1) missing."""
    if (r, c) == (1, 1):
        return None
    rng = np.random.default_rng(r * 100 + c)
    return rng.poisson(lam=np.arange(1, 7)[None, None, None, :],
                       size=(4, 4, 2, 6)).astype(np.float32)


def test_gene_stats_equal_jax(tmp_path):
    tiles = [(r, c) for r in range(2) for c in range(3)]
    names = ["a", "b", "c", "d", "e", "f"]

    def mask(r, c, stack):
        m = np.zeros(stack.shape[:2], bool)
        m[(r + c) % 2:] = True
        return m

    for kw in ({}, {"mask_fn": mask}):
        ot = tgs.region_gene_stats(gene_provider, tiles, gdim=5, **kw)
        oj = jgs.region_gene_stats(gene_provider, tiles, gdim=5, **kw)
        np.testing.assert_array_equal(ot.mean, oj.mean)
        np.testing.assert_array_equal(ot.std, oj.std)
        assert tgs.top_genes(ot, names, k=3) == jgs.top_genes(oj, names, k=3)
        tgs.save_stats_csv(ot, names, tmp_path / "t.csv")
        jgs.save_stats_csv(oj, names, tmp_path / "j.csv")
        assert (tmp_path / "t.csv").read_bytes() == \
            (tmp_path / "j.csv").read_bytes()
    for gi in (0, 4):
        np.testing.assert_array_equal(
            tgs.gene_expression_map(gene_provider, tiles, gi),
            jgs.gene_expression_map(gene_provider, tiles, gi))
    tgs.save_gene_heatmaps(gene_provider, tiles, names, [1, 5],
                           tmp_path / "maps")
    assert sorted(p.name for p in (tmp_path / "maps").iterdir()) == \
        ["b.png", "f.png"]


def test_morphology_classical_equals_jax():
    rng = np.random.default_rng(4)
    gen = [2 * t - 1 for t in blobs(rng, 3, size=96)]
    real = blobs(rng, 3, size=96, intensity=0.7)
    expr = rng.random((96, 96)).astype(np.float32)
    for img in gen[:2]:
        for kw in ({}, {"expression": expr}):
            st = tmorph.nuclei_stats(img, use_cellpose=False, **kw)
            sj = jmorph.nuclei_stats(img, use_cellpose=False, **kw)
            assert st.count == sj.count > 0
            np.testing.assert_array_equal(st.sizes, sj.sizes)
            np.testing.assert_array_equal(st.intensities, sj.intensities)
            assert st.summary() == sj.summary()
    np.testing.assert_array_equal(
        tmorph._segment_classical(real[0], thresh=0.3),
        jmorph._segment_classical(real[0], thresh=0.3))
    assert tmorph.compare_morphology(gen, real, use_cellpose=False) == \
        jmorph.compare_morphology(gen, real, use_cellpose=False)
    img = (255 * np.stack([np.stack([t, t]) for t in real])).astype(np.uint8)
    img[1] = 0                                   # a black slice
    masks = [jmorph._segment_classical(t) for t in (real[0], real[2])]
    for got, want in zip(tmorph.stats_from_masks(img, masks),
                         jmorph.stats_from_masks(img, masks)):
        np.testing.assert_array_equal(got, want)
    assert tmorph.stats_from_masks(np.zeros_like(img), []) is None


def test_cellpose_absent_gives_classical(monkeypatch):
    monkeypatch.setitem(sys.modules, "cellpose", None)
    assert tmorph._segment_cellpose(np.zeros((8, 8), np.float32)) is None
    img = blobs(np.random.default_rng(5), 1, size=96)[0]
    assert tmorph.nuclei_stats(img).summary() == \
        tmorph.nuclei_stats(img, use_cellpose=False).summary()


# --------------------------------------------------------------------- #
# InceptionV3                                                             #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def replica():
    """The live torch replica's weights (tests/inception_torch_replica),
    as JAX variables and as named tensors."""
    m = build_torch_inception(seed=0)
    npar = {k: v.detach().numpy() for k, v in m.named_parameters()}
    nbuf = {k: v.detach().numpy() for k, v in m.named_buffers()
            if "num_batches_tracked" not in k}
    return jinc.convert_torch_inception(npar, nbuf), {**npar, **nbuf}


@pytest.mark.parametrize("fid_variant", [True, False])
def test_inception_matches_jax(replica, fid_variant):
    """The port's module on the replica's weights (loaded by name, and
    carried across from JAX's variables) against JAX's module, at
    tests/test_inception.py's tolerance.  139 px: the smallest grid keeps
    every padded pooling edge in play."""
    variables, named = replica
    x = np.random.default_rng(0).standard_normal((2, 139, 139, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jinc.InceptionV3Features(
        fid_variant=fid_variant).apply)(variables, jnp.asarray(x)))
    model = tinc.load_torch_inception(
        tinc.InceptionV3Features(fid_variant), named).eval()
    carried = tinc.inception_state_from_flax(variables)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(carried[k], v.numpy(), err_msg=k)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    scale = float(np.abs(want).mean())
    mae = float(np.abs(got - want).mean())
    assert mae <= 1e-4 * max(scale, 1.0), (mae, scale)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


@pytest.fixture(scope="module")
def traced_export(tmp_path_factory, replica):
    """The port's InceptionV3 on the replica's weights, traced to a
    torchscript file under a wrapper attribute (as exports nest it)."""
    _, named = replica

    class Wrapper(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = tinc.load_torch_inception(
                tinc.InceptionV3Features(), named).eval()

        def forward(self, x):
            return self.layers(x)

    path = tmp_path_factory.mktemp("inception") / "export.pt"
    torch.jit.trace(Wrapper().eval(), torch.zeros(1, 3, 299, 299)).save(
        str(path))
    return path


def test_inception_features_match_flax(traced_export):
    """``InceptionFeatures`` on the export against JAX's
    ``FlaxInceptionFeatures`` on it: a 256 px batch (upsampled) and a
    320 px one (downsampled, where the resize antialiases), one channel
    and three."""
    ours = tinc.InceptionFeatures(str(traced_export), device="cpu")
    theirs = jinc.FlaxInceptionFeatures(str(traced_export))
    rng = np.random.default_rng(1)
    for shape in ((2, 256, 256), (2, 320, 320, 3)):
        x = np.tanh(rng.standard_normal(shape)).astype(np.float32)
        got, want = ours(x), theirs(x)
        assert got.shape == want.shape == (2, 2048)
        scale = float(np.abs(want).mean())
        assert float(np.abs(got - want).mean()) <= 1e-4 * max(scale, 1.0)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


def test_torchscript_features_equal_jax(tmp_path):
    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 8, 3, stride=4)

        def forward(self, x):
            h = torch.relu(self.conv(x))
            return torch.flatten(
                torch.nn.functional.adaptive_avg_pool2d(h, 2), 1)

    torch.manual_seed(0)
    path = tmp_path / "toy.pt"
    torch.jit.script(Toy().eval()).save(str(path))
    ours = tfeat.TorchscriptFeatures(path, dim=32, resize=64, device="cpu")
    theirs = jfeat.TorchscriptFeatures(path, dim=32, resize=64)
    rng = np.random.default_rng(2)
    for shape in ((3, 48, 48), (2, 48, 48, 1), (2, 80, 80, 3)):
        x = rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(ours(x), theirs(x))


def test_clip_refused_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tfeat.CLIPFeatures("any_dir", device="cpu")


@pytest.mark.parametrize("chans", [1, 2, 3])
def test_clip_preprocess_equals_jax(chans):
    x = np.random.default_rng(chans).uniform(
        0, 255, (3, 40, 44, chans)).astype(np.float32)
    np.testing.assert_array_equal(tfeat.clip_preprocess(x, 24),
                                  jfeat.clip_preprocess(x, 24))


def test_clip_features_on_a_local_tiny_clip(tmp_path):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(7)
    cfg = transformers.CLIPConfig(
        text_config=transformers.CLIPTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=2, max_position_embeddings=16,
            vocab_size=99).to_dict(),
        vision_config=transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=32, patch_size=8).to_dict(),
        projection_dim=16)
    pt = transformers.CLIPModel(cfg).eval()
    pt.save_pretrained(tmp_path)
    fx = tfeat.CLIPFeatures(str(tmp_path), device="cpu")
    assert (fx.dim, fx.size) == (16, 32)
    x = np.random.default_rng(3).uniform(0, 255, (2, 48, 48, 2)).astype(
        np.float32)
    with torch.no_grad():
        want = pt.get_image_features(pixel_values=torch.from_numpy(
            jfeat.clip_preprocess(x, 32))).numpy()
    np.testing.assert_allclose(fx(x), want, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------- #
# cli.evaluate                                                            #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Generated and real float16 tile stores, 3 tiles of 176^2 px x 2
    channels (MS-SSIM needs 160 px), one real tile missing."""
    tmp = tmp_path_factory.mktemp("eval")
    gen, real = TileStore(tmp / "gen").create(), TileStore(tmp / "real") \
        .create()
    for i, name in enumerate(["0_256_0_256", "0_256_256_512",
                              "256_512_0_256", "256_512_256_512"]):
        a, b = image_pair((176, 176, 2), 10 + i)
        gen.write(name, a.astype(np.float16))
        if i != 2:
            real.write(name, b.astype(np.float16))
    return tmp


def jax_report(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["evaluate"] + argv)
    jeval.main()
    return json.loads(Path(argv[argv.index("--report") + 1]).read_text())


@pytest.mark.parametrize("channel", [0, 1])
def test_evaluate_report_matches_jax(stores, monkeypatch, channel):
    argv = ["--gen_dir", str(stores / "gen"), "--real_dir",
            str(stores / "real"), "--channel", str(channel)]
    want = jax_report(monkeypatch, argv + ["--report",
                                           str(stores / f"j{channel}.json")])
    got = teval.main(argv + ["--report", str(stores / f"t{channel}.json"),
                             "--device", "cpu"])
    assert json.loads((stores / f"t{channel}.json").read_text()) == got
    assert sorted(got) == sorted(want)
    assert got["n_paired"] == 3 and "ms_ssim" in got
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k


def test_evaluate_refusals(stores):
    base = ["--gen_dir", str(stores / "gen"), "--real_dir",
            str(stores / "real")]
    with pytest.raises(SystemExit, match="feature_weights"):
        teval.main(base + ["--features", "inception", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            teval.main(base)
    gen_only = teval.main(["--gen_dir", str(stores / "gen"), "--device",
                           "cpu", "--max_tiles", "2"])
    assert sorted(gen_only) == ["gen_dir", "gen_mean", "gen_std", "n_tiles"]


def test_metrics_modules_import_no_plotting_or_clip_package():
    """matplotlib and transformers load only inside the functions that
    use them."""
    probe = ("import sys, tera_mind_tpu_torch.metrics.features, "
             "tera_mind_tpu_torch.metrics.gene_stats, "
             "tera_mind_tpu_torch.metrics.inception, "
             "tera_mind_tpu_torch.metrics.morphology, "
             "tera_mind_tpu_torch.cli.attn, tera_mind_tpu_torch.cli.evaluate;"
             "print(sorted(k for k in sys.modules if k.split('.')[0] in "
             "('matplotlib', 'transformers', 'cellpose')))")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"

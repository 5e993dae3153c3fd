"""The port's figure utilities (``assembly/vis.py``) against the JAX
package's on seeded inputs: integer outputs exactly, floats within
1e-6."""

import filecmp

import numpy as np
import pytest

from tera_mind_tpu.assembly import vis as jv
from tera_mind_tpu_torch.assembly import vis as tv

RNG_SEED = 3


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture()
def rng():
    return np.random.default_rng(RNG_SEED)


@pytest.mark.parametrize("lo", [-1.0, 0.0])
def test_to_uint8(rng, lo):
    x = rng.uniform(lo - 0.1, 1.1, (17, 13, 3)).astype(np.float32)
    same(tv.to_uint8(x), jv.to_uint8(x))


@pytest.mark.parametrize("ndim", [2, 3])
def test_gen_roi_and_zoom(rng, ndim):
    img = rng.uniform(-1, 1, (40, 50) + (3,) * (ndim - 2))
    for got, want in zip(tv.gen_roi(img, 5, 7, 20, 30, border=3,
                                    color=(10, 200, 30)),
                         jv.gen_roi(img, 5, 7, 20, 30, border=3,
                                    color=(10, 200, 30))):
        same(got, want)
    same(tv.gen_zoom(img, 3, 4, 8, scale=3), jv.gen_zoom(img, 3, 4, 8,
                                                         scale=3))


def test_color_overlay(rng):
    base = rng.uniform(-1, 1, (24, 20))
    layers = [rng.random((24, 20)), np.full((24, 20), 0.5),
              rng.random((24, 20)) * 3]
    cols = [(0, 1, 0.82), (1, 0.4, 0), (0.2, 0.3, 1)]
    same(tv.color_overlay(base, layers, cols, alpha=0.6),
         jv.color_overlay(base, layers, cols, alpha=0.6))


@pytest.mark.parametrize("region", ["all", "half", "rhalf", "thalf",
                                    "bhalf", "main", "quarter", "3quarter"])
def test_region_mask_and_onto_overlay(rng, region):
    onto = rng.integers(0, 3, (30, 22, 3)).astype(np.uint8) * 100
    same(tv.region_mask(onto, region), jv.region_mask(onto, region))
    img = rng.uniform(-1, 1, (30, 22))
    for bright in (None, 1.7):
        same(tv.onto_overlay(img, onto, region=region, alpha=90,
                             bright=bright),
             jv.onto_overlay(img, onto, region=region, alpha=90,
                             bright=bright))


def test_region_mask_refuses_an_unknown_region():
    for mod in (tv, jv):
        with pytest.raises(ValueError, match="unknown region"):
            mod.region_mask(np.zeros((4, 4, 3)), "left")


@pytest.mark.parametrize("mask_ndim", [2, 3])
def test_merge_mask(rng, mask_ndim):
    img = rng.uniform(0, 1, (16, 18, 3))
    mask = rng.integers(0, 2, (16, 18) + (3,) * (mask_ndim - 2))
    same(tv.merge_mask(img, mask, alpha=120), jv.merge_mask(img, mask,
                                                            alpha=120))


def test_metric_table():
    rows = [{"cell": "ours", "psnr": 21.5, "ssim": 0.61},
            {"cell": "patch-dm", "psnr": 18.25},
            {"cell": "sinf", "ssim": 0.4, "extra": 1}]
    cols = ["cell", "psnr", "ssim"]
    assert tv.metric_table(rows, cols) == jv.metric_table(rows, cols)


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_save_png(rng, tmp_path, kind):
    img = rng.uniform(-1, 1, (20, 30, 3)) if kind == "float" else \
        rng.integers(0, 256, (20, 30), dtype=np.uint8)
    tv.save_png(img, tmp_path / "t.png")
    jv.save_png(img, tmp_path / "j.png")
    assert filecmp.cmp(tmp_path / "t.png", tmp_path / "j.png", shallow=False)


@pytest.mark.parametrize("shape", [(8, 8), (8, 8, 3)])
def test_stitch_tiles(rng, shape):
    tiles = {(r, c): rng.random(shape).astype(np.float32)
             for r in range(3) for c in range(2)}
    same(tv.stitch_tiles(lambda r, c: tiles[(r, c)], 3, 2, tile=8),
         jv.stitch_tiles(lambda r, c: tiles[(r, c)], 3, 2, tile=8))
    # a WSI-scale request is refused (None) by both
    assert tv.stitch_tiles(lambda r, c: tiles[(0, 0)], 3, 2, tile=8,
                           max_px=16) is None
    assert jv.stitch_tiles(lambda r, c: tiles[(0, 0)], 3, 2, tile=8,
                           max_px=16) is None

"""The port's WSI assembly (``assembly/wsi.py``, ``cli.assemble``) against
the JAX package's, on the CPU: the same tiles through the same C++ writer
give byte-equal files, level 0 reads back bit-exact through Pillow, and
every pyramid level equals the JAX file's."""

import filecmp
import sys

import numpy as np
import pytest
from PIL import Image

from tera_mind_tpu import constants as jconst
from tera_mind_tpu.assembly import wsi as jwsi
from tera_mind_tpu.cli import assemble as jcli
from tera_mind_tpu.data.tilestore import TileStore as JTileStore
from tera_mind_tpu_torch import constants as tconst
from tera_mind_tpu_torch.assembly import wsi as twsi
from tera_mind_tpu_torch.cli import assemble as tcli
from tera_mind_tpu_torch.data.tilestore import TileStore, tile_name


def grid_tiles(rows, cols, kind, seed=0, tile=256):
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        return {(r, c): rng.integers(0, 256, (tile, tile), dtype=np.uint8)
                for r in range(rows) for c in range(cols)}
    return {(r, c): rng.uniform(-1.05, 1.05, (tile, tile)).astype(np.float32)
            for r in range(rows) for c in range(cols)}


def frames(path):
    """Every pyramid level of a TIFF as a numpy array, top first."""
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.array(im))
    return out


def as_uint8(t):
    return t if t.dtype == np.uint8 else \
        np.clip((t.astype(np.float32) + 1) * 127.5, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("rows,cols,kind", [(2, 3, "uint8"), (2, 3, "float"),
                                            (5, 7, "float"), (3, 9, "uint8")])
def test_assemble_slice_byte_equal_to_jax(tmp_path, rows, cols, kind):
    """uint8 and [-1, 1] float tiles (a few beyond the range, clipped), at
    odd grids whose pyramids have 3 to 5 levels and odd level widths."""
    tiles = grid_tiles(rows, cols, kind, seed=rows * cols)
    for mod, name in ((twsi, "t.tif"), (jwsi, "j.tif")):
        mod.assemble_slice(lambda r, c: tiles[(r, c)], tmp_path / name,
                           rows, cols)
    assert filecmp.cmp(tmp_path / "t.tif", tmp_path / "j.tif", shallow=False)
    got, want = frames(tmp_path / "t.tif"), frames(tmp_path / "j.tif")
    assert len(got) == len(want) == twsi.pyramid_levels(cols * 256,
                                                        rows * 256) >= 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    full = np.zeros((rows * 256, cols * 256), np.uint8)
    for (r, c), t in tiles.items():
        full[r * 256:(r + 1) * 256, c * 256:(c + 1) * 256] = as_uint8(t)
    np.testing.assert_array_equal(got[0], full)
    # level 1 is the 2x box mean of level 0, truncated
    ds = full.astype(np.float32).reshape(rows * 128, 2, cols * 128, 2)
    np.testing.assert_array_equal(got[1], ds.mean((1, 3)).astype(np.uint8))


@pytest.mark.parametrize("compression,extra", [("jpeg", dict(quality=95)),
                                               ("none", {}),
                                               ("deflate", dict(zlevel=1))])
def test_writer_compressions_byte_equal_to_jax(tmp_path, compression, extra):
    y, x = np.mgrid[0:768, 0:1280]
    data = ((y + 2 * x) / 5 % 200).astype(np.uint8)
    for mod, name in ((twsi, "t.tif"), (jwsi, "j.tif")):
        w = mod.WsiWriter(tmp_path / name, 1280, 768,
                          compression=compression, **extra)
        for ty in range(3):
            w.write_row_strip(ty, data[ty * 256:(ty + 1) * 256])
        w.close()
    assert filecmp.cmp(tmp_path / "t.tif", tmp_path / "j.tif", shallow=False)
    got = frames(tmp_path / "t.tif")
    assert len(got) == 4
    if compression == "jpeg":
        assert np.abs(got[0].astype(int) - data).mean() < 3.0
    else:
        np.testing.assert_array_equal(got[0], data)


def test_missing_tiles_are_blank_as_in_jax(tmp_path):
    for mod, name in ((twsi, "t.tif"), (jwsi, "j.tif")):
        w = mod.WsiWriter(tmp_path / name, 512, 512, levels=1)
        w.write_tile(0, 0, np.full((256, 256), 200, np.uint8))
        w.write_tile(1, 1, np.full((100, 50), 9, np.uint8))   # padded
        w.close()
    assert filecmp.cmp(tmp_path / "t.tif", tmp_path / "j.tif", shallow=False)
    arr = frames(tmp_path / "t.tif")[0]
    assert (arr[:256, :256] == 200).all()
    assert (arr[:256, 256:] == 0).all() and (arr[256:, :256] == 0).all()
    assert (arr[256:356, 256:306] == 9).all()
    assert arr[256:, 256:].sum() == 9 * 100 * 50


@pytest.mark.parametrize("w,h,c", [(256, 256, 1), (73728, 106496, 1),
                                   (768, 512, 3)])
def test_ome_xml_equals_jax(tmp_path, w, h, c):
    assert twsi.ome_xml(w, h, c) == jwsi.ome_xml(w, h, c)
    twsi.assemble_slice(lambda r, cc: np.zeros((256, 256), np.uint8),
                        tmp_path / "a.tif", 1, 1)
    with Image.open(tmp_path / "a.tif") as im:
        assert im.tag_v2.get(270) == twsi.ome_xml(256, 256)


def test_writer_source_and_constants_equal_jax():
    assert twsi.SRC.read_bytes() == (
        jwsi._CPP_DIR / "wsi_tiff.cc").read_bytes()
    for name in ("TILE_SIZE", "BRAIN_GRID_FULL", "BRAIN_GRID_GEN",
                 "BRAIN_GRID_START", "HBR", "CM", "MOUSE_EXL"):
        assert getattr(tconst, name) == getattr(jconst, name), name


def test_writer_builds_into_the_build_dir_and_reports_g_plus_plus(
        tmp_path, monkeypatch):
    """The library is built at first use under ``_build/``, named by a
    hash of the source and flags; a build failure raises with g++'s
    message."""
    twsi._lib()
    so = twsi.lib_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "tera_mind_tpu_torch"
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(twsi, "SRC", bad)
    monkeypatch.setattr(twsi, "BUILD_DIR", tmp_path / "build")
    assert twsi.lib_path() != so
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        twsi.build()
    assert not list((tmp_path / "build").glob("*.so"))


def write_store(root, rows, cols, hst, wst, chans, seed=0):
    rng = np.random.default_rng(seed)
    store = TileStore(root).create()
    for r in range(rows):
        for c in range(cols):
            h0, w0 = hst + r * 256, wst + c * 256
            store.write(tile_name(h0, h0 + 256, w0, w0 + 256),
                        rng.uniform(-1, 1, (256, 256, chans))
                        .astype(np.float16))
    return store


@pytest.mark.parametrize("extra", [["--preview"],
                                   ["--slices", "0,2", "--stain", "DAPI"]])
def test_cli_assemble_matches_jax(tmp_path, monkeypatch, extra):
    """``cli.assemble`` on a port tile store against JAX's CLI on the same
    store: the same files, byte-equal (the previews too)."""
    rows, cols, hst, wst = 2, 3, 512, 256
    store = write_store(tmp_path / "tiles", rows, cols, hst, wst, 8)
    assert JTileStore(store.root).read(store.names()[0]).shape == \
        (256, 256, 8)
    common = ["--gdir", str(store.root), "--hst", str(hst), "--wst",
              str(wst), "--hnm", str(rows), "--wnm", str(cols), *extra]
    written = tcli.main(common + ["--odir", str(tmp_path / "t")])
    monkeypatch.setattr(sys, "argv", ["assemble", *common, "--odir",
                                      str(tmp_path / "j")])
    jcli.main()
    tnames = sorted(p.name for p in (tmp_path / "t").iterdir())
    jnames = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert tnames == jnames
    n = 8 if extra == ["--preview"] else 2
    assert len(written) == n
    assert len(tnames) == (2 * n if "--preview" in extra else n)
    for name in tnames:
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False), name
    # level 0 of a file is its channel of the tiles, bit-exact
    ch, path = (5, "all_PolyT_1.tif") if extra == ["--preview"] else \
        (2, "all_DAPI_2.tif")
    want = np.zeros((rows * 256, cols * 256), np.uint8)
    for r in range(rows):
        for c in range(cols):
            h0, w0 = hst + r * 256, wst + c * 256
            t = store.read(tile_name(h0, h0 + 256, w0, w0 + 256))[..., ch]
            want[r * 256:(r + 1) * 256, c * 256:(c + 1) * 256] = as_uint8(t)
    np.testing.assert_array_equal(frames(tmp_path / "t" / path)[0], want)

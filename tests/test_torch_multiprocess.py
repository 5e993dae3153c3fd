"""The port's multi-process generation against the JAX package, on the CPU.

Ranks run as subprocesses over gloo (``--device cpu``, one torch thread,
a process-group timeout of 60 s, 120 s per subprocess), each importing
this module without JAX: the ``child_*`` functions below are what a rank
runs, and they write their results into a temporary directory.  The JAX
package's own mesh tests are ``cpu_mesh`` and skip here, so the
reference is JAX's single-device run, which those tests state equals its
sharded run:

- ``exchange_halo_2d`` over 1x1, 1x2, 2x1 and 2x2 rank grids, bit-equal
  to JAX's ``pad_halo_single`` of the whole image cut to each rank's
  window (f32 and bf16);
- ``band_partition`` and ``StripExchange`` over 3 ranks;
- the ``'jax'`` noise backend against ``jax.random.normal``;
- the sharded step (leaky model, block- and tile-major) and the sharded
  tiny packed chain on a 2x2 rank grid;
- band streaming over 2 ranks, K = 1 and K = 2, and ``devices=``;
- ``mp_demo`` over 2 and 4 ranks, ``cli.generate.main`` over 2 ranks (in
  memory and ``--stream``: tiles, ``_p{rank}`` spills, ``--cur_epoch``);
- the backend rule.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tera_mind_tpu_torch.cli import generate as tcli
from tera_mind_tpu_torch.convert import load_jax_params
from tera_mind_tpu_torch.data import noise as tnoise
from tera_mind_tpu_torch.data.tilestore import TileStore
from tera_mind_tpu_torch.diffusion.sampler import (DiffusionSampler,
                                                   SamplerConfig)
from tera_mind_tpu_torch.diffusion.schedule import spaced_schedule
from tera_mind_tpu_torch.models.unet import TeraUNetConfig
from tera_mind_tpu_torch.models.unet_packed import make_packed_model
from tera_mind_tpu_torch.ops.collage import to_collage
from tera_mind_tpu_torch.parallel import band as tband
from tera_mind_tpu_torch.parallel import generator as tgen
from tera_mind_tpu_torch.parallel import halo as thalo
from tera_mind_tpu_torch.parallel import mesh as tmesh
from tera_mind_tpu_torch.parallel import mp_demo as tdemo
from tera_mind_tpu_torch.parallel import streaming as tstream

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
TOY_ATOL = 1e-5          # f32 sums in another order
CHAIN_TOL = dict(atol=2e-4, rtol=1e-3)   # JAX's test_generator.py:348
# the tiny packed UNet and geometry of tests/test_torch_generator.py
MKW = dict(image_size=32, in_channels=2, out_channels=2, model_channels=8,
           embed_channels=32, num_res_blocks=1, channel_mult=(1, 2, 4, 8),
           attention_resolutions=(8,), rna_num=6, gn_sz=2)
GKW = dict(tile=64, patch=32, gn_blk=16, snum=4, n_slices=4, stains=1,
           gdim=6, window_chunk=1)
# the toy model's geometry of tests/test_torch_streaming.py
TOY = dict(tile=64, patch=32, gn_blk=16, snum=4, n_slices=4, stains=2,
           gdim=8)


# --------------------------------------------------------------------------
# running ranks
# --------------------------------------------------------------------------

def spawn(n: int, fn: str, *args) -> list:
    """Run ``fn(rank, n, port, *args)`` of this module in ``n`` fresh
    processes (one torch thread each) and return their outputs; every
    rank must exit 0 within ``RANK_TIMEOUT_S``."""
    port = tmesh.free_port()
    boot = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(TESTS)!r}]; "
            f"import test_torch_multiprocess as t; t.{fn}(*sys.argv[1:])")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", boot, str(r), str(n), str(port),
         *map(str, args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {fn}:\n{out[-4000:]}"
    return outs


def join(rank, n, port) -> torch.device:
    torch.set_num_threads(1)
    return tmesh.multihost_init(f"127.0.0.1:{port}", int(n), int(rank),
                                device="cpu", timeout_s=GROUP_TIMEOUT_S)


def save(out_dir, rank, **arrays) -> None:
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)


def load(out_dir, rank) -> dict:
    return dict(np.load(Path(out_dir) / f"rank{rank}.npz"))


def as_f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# the backend rule and the mesh
# --------------------------------------------------------------------------

def test_backend_rule_and_rank_devices():
    assert tmesh.choose_backend("cpu", 4, 0) == "gloo"
    assert tmesh.choose_backend("cuda", 2, 1) == "gloo"     # a shared card
    assert tmesh.choose_backend("cuda", 2, 2) == "nccl"
    assert tmesh.choose_backend("cuda", 1, 8) == "nccl"
    assert tmesh.rank_device("cpu", 3) == torch.device("cpu")
    # no process group: a no-op that returns the device
    assert tmesh.multihost_init(None, device="cpu") == torch.device("cpu")
    assert tmesh.world() == (0, 1) and tmesh.is_primary()
    assert tmesh.host_broadcast({"a": 1}) == {"a": 1}
    tmesh.host_barrier("alone")
    m = tmesh.make_mesh(("gr", "gc"), (1, -1), device="cpu")
    assert (m.shape, m.coords, m.neighbors, m.group) == (
        (1, 1), (0, 0), ((None, None), (None, None)), None)
    with pytest.raises(ValueError, match="holds 4 ranks"):
        tmesh.make_mesh(("gr", "gc"), (2, 2), device="cpu")


def child_backend(rank, n, port, out_dir):
    """An explicit backend wins over the rule."""
    torch.set_num_threads(1)
    tmesh.multihost_init(f"127.0.0.1:{port}", int(n), int(rank),
                         device="cpu", backend="gloo",
                         timeout_s=GROUP_TIMEOUT_S)
    assert torch.distributed.get_backend() == "gloo"
    tmesh.shutdown()


# --------------------------------------------------------------------------
# the halo exchange and the band strips
# --------------------------------------------------------------------------

HALO_BLOCK = (6, 5, 3)    # a rank's (H, W, C)
HALO_PAD = 2
HALO_MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}


def halo_image(shape, dtype):
    """The whole (R*H, C*W, ch) image of a mesh of ``shape``; each value
    encodes its position, so a strip from the wrong rank or offset shows."""
    h, w, ch = HALO_BLOCK
    R, C = shape
    y, x, z = np.meshgrid(np.arange(R * h), np.arange(C * w),
                          np.arange(ch), indexing="ij")
    img = (y * 64 + x + z / 4).astype(np.float32) / 64
    return torch.from_numpy(img).to(dtype)


def child_halo(rank, n, port, out_dir):
    rank = int(rank)
    join(rank, n, port)
    res = {}
    for shape in HALO_MESHES[int(n)]:
        mesh = tmesh.make_mesh(("gr", "gc"), shape, device="cpu")
        r, c = mesh.coords
        h, w, _ = HALO_BLOCK
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            img = halo_image(shape, dt)
            thalo.reset_stats()
            out = thalo.exchange_halo_2d(
                img[r * h:(r + 1) * h, c * w:(c + 1) * w].clone(), HALO_PAD,
                mesh)
            assert out.dtype == dt
            res[f"{shape}_{name}"] = as_f32(out)
            want = thalo.exchange_bytes(HALO_BLOCK, HALO_PAD, dt.itemsize,
                                        mesh.coords, shape)
            assert thalo.stats["bytes"] == want, (thalo.stats, want)
            assert thalo.stats["by_route"]["gloo"] == 1
    save(out_dir, rank, **res)
    tmesh.shutdown()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_exchange_halo_2d_is_bit_equal_to_jax_pad(tmp_path, n):
    """Each rank's padded block equals JAX's pad_halo_single of the whole
    image cut to the rank's window, bit for bit (1x1 runs in-process)."""
    import jax.numpy as jnp

    from tera_mind_tpu.parallel.halo import pad_halo_single as j_pad
    if n == 1:
        got = {0: {f"(1, 1)_{k}": as_f32(thalo.exchange_halo_2d(
            halo_image((1, 1), dt), HALO_PAD, tmesh.make_mesh(
                ("gr", "gc"), (1, 1))))
            for k, dt in (("f32", torch.float32),
                          ("bf16", torch.bfloat16))}}
        meshes = [(1, 1)]
    else:
        spawn(n, "child_halo", tmp_path)
        got = {r: load(tmp_path, r) for r in range(n)}
        meshes = HALO_MESHES[n]
    h, w, _ = HALO_BLOCK
    p = HALO_PAD
    for shape in meshes:
        for name, jdt, dt in (("f32", jnp.float32, torch.float32),
                              ("bf16", jnp.bfloat16, torch.bfloat16)):
            img = as_f32(halo_image(shape, dt))
            full = np.asarray(j_pad(jnp.asarray(img, jdt), p), np.float32)
            for rank in range(n):
                r, c = rank // shape[1], rank % shape[1]
                np.testing.assert_array_equal(
                    got[rank][f"{shape}_{name}"],
                    full[r * h:(r + 1) * h + 2 * p, c * w:(c + 1) * w + 2 * p],
                    err_msg=f"mesh {shape} rank {rank} {name}")


def child_strips(rank, n, port, out_dir):
    rank = int(rank)
    join(rank, n, port)
    res = {}
    for name, dt in (("f32", np.float32), ("bf16", "bfloat16")):
        ex = tband.StripExchange(3, 4, 2, dtype=dt)
        top = np.full((3, 4, 2), 10 * rank + 1, np.float32)
        bot = np.full((3, 4, 2), 10 * rank + 2, np.float32)
        gt, gb = ex(top, bot)
        for key, g in (("top", gt), ("bot", gb)):
            if g is not None:
                res[f"{name}_{key}"] = as_f32(g)
    assert tband.stats["calls"] == 2
    save(out_dir, rank, **res)
    tmesh.shutdown()


def test_band_partition_and_strip_exchange(tmp_path):
    """band_partition equals JAX's over a sweep; over 3 ranks each ghost
    is the neighbour's edge (f32 and bf16), None at the first and last
    band; one process gets (None, None)."""
    from tera_mind_tpu.parallel.band import band_partition as j_part
    for total in range(1, 12):
        for nproc in range(1, total + 1):
            for rank in range(nproc):
                assert tband.band_partition(total, nproc, rank) == \
                    j_part(total, nproc, rank)
    with pytest.raises(ValueError):
        tband.band_partition(2, 3, 0)
    assert tband.StripExchange(2, 3, 1)(np.zeros((2, 3, 1)),
                                        np.zeros((2, 3, 1))) == (None, None)
    spawn(3, "child_strips", tmp_path)
    for rank in range(3):
        got = load(tmp_path, rank)
        for name in ("f32", "bf16"):
            assert (f"{name}_top" in got) == (rank > 0)
            assert (f"{name}_bot" in got) == (rank < 2)
            if rank > 0:
                assert (got[f"{name}_top"] == 10 * (rank - 1) + 2).all()
            if rank < 2:
                assert (got[f"{name}_bot"] == 10 * (rank + 1) + 1).all()


# --------------------------------------------------------------------------
# the 'jax' noise backend
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [
    (0, (5,)), (1, (3, 7, 2)), (2 ** 31 - 1, (17, 33)),
    (tnoise.tile_seed(3, 4, 416), (256, 256, 100))])
def test_jax_noise_backend_is_bit_equal(seed, shape):
    """The threefry bits and the normals equal jax.random.normal's bit for
    bit (so 0 values, 0 ulps apart)."""
    import jax
    import jax.numpy as jnp
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        tnoise.jax_random_bits(seed, shape),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    got = tnoise.jax_normal(seed, shape)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_jax_noise_grid_and_tile_init():
    """grid_init_noise_jax over a 2x3 block equals JAX's vmapped per-tile
    normal at the tiles' LCG seeds; JAX's own grid_init_noise_jax
    overflows int32 here (no x64), so the vmapped body is the reference.
    tile_init_noise(backend='jax') is JAX's."""
    import jax
    import jax.numpy as jnp

    from tera_mind_tpu.data import noise as jn
    shape = (8, 8, 4)
    got = tnoise.grid_init_noise_jax(2, 3, 16, shape, row0=1, col0=2)
    seeds = np.array([[tnoise.tile_seed(1 + r, 2 + c, 16) for c in range(3)]
                      for r in range(2)], np.uint32)
    want = jax.vmap(jax.vmap(lambda s: jax.random.normal(
        jax.random.PRNGKey(s), shape, jnp.float32)))(seeds)
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(OverflowError):
        jn.grid_init_noise_jax(2, 3, 16, shape, row0=1, col0=2)
    np.testing.assert_array_equal(
        tnoise.tile_init_noise(2, 5, 16, shape, backend="jax"),
        jn.tile_init_noise(2, 5, 16, shape, backend="jax"))
    with pytest.raises(ValueError, match="noise backend"):
        tnoise.tile_init_noise(0, 0, 16, shape, backend="numpy")


# --------------------------------------------------------------------------
# the sharded generator
# --------------------------------------------------------------------------

LEAKY_GRID = 4     # 4x4 tiles of 32 px over a 2x2 mesh: 2x2 tiles a rank


def field_gene(conf, rows, cols, seed):
    """Per-tile bins cut from one field (neighbours' halos agree)."""
    nb, hb = conf["tile"] // conf["gn_blk"], conf["patch"] // 2 // \
        conf["gn_blk"]
    n_slices = conf["n_slices"] + 2 * {1: 0, 4: 1, 8: 1, 16: 3}[conf["snum"]]
    field = np.random.default_rng(seed).integers(
        0, 3, (rows * nb + 2 * hb, cols * nb + 2 * hb, n_slices,
               conf["gdim"])).astype(np.uint8)
    return np.stack([np.stack([field[r * nb:r * nb + nb + 2 * hb,
                                     c * nb:c * nb + nb + 2 * hb]
                               for c in range(cols)]) for r in range(rows)])


def leaky_conf() -> dict:
    g = tdemo._gconf()
    return {k: getattr(g, k) for k in ("tile", "patch", "gn_blk", "snum",
                                       "n_slices", "stains", "gdim")}


def child_leaky(rank, n, port, out_dir):
    """The sharded steps and run of the leaky model on a 2x2 mesh."""
    rank = int(rank)
    dev = join(rank, n, port)
    inp = dict(np.load(Path(out_dir) / "inputs.npz"))
    mesh = tmesh.make_mesh(("gr", "gc"), (2, 2), device=dev)
    gen = tdemo._make_gen(mesh)
    g = LEAKY_GRID
    r0, c0, lr, lc = gen.local_block(g, g)
    t = tdemo._gconf().tile
    state = torch.from_numpy(inp["state"][r0 * t:(r0 + lr) * t,
                                          c0 * t:(c0 + lc) * t])
    gene = torch.from_numpy(inp["gene"][r0:r0 + lr, c0:c0 + lc])
    res = {name: gen.compile_step(g, g, block_major=bm)(state, gene,
                                                         1).numpy()
           for name, bm in (("block", True), ("tile", False))}
    res["run"] = gen.run(lambda r, c: inp["gene"][r, c], rows=g, cols=g,
                         row0=1, col0=1, grid_w=16, progress=False,
                         block_major=True)
    res["offset"] = np.array(gen._local_offset)
    save(out_dir, rank, **res)
    tmesh.shutdown()


def test_sharded_leaky_step_and_run_match_jax(tmp_path):
    """One sharded step (block- and tile-major) of the leaky model on a
    2x2 rank grid equals JAX's single-device compile_step within 1e-5,
    and a provider-fed 3-step run (each rank building only its block's
    genes and 'jax' noise) equals JAX's run."""
    import jax.numpy as jnp

    from tera_mind_tpu.parallel.mp_demo import _make_gen as j_make_gen
    g = LEAKY_GRID
    jg = j_make_gen(None)
    state = jg.init_state(g, g, row0=1, col0=1, grid_w=16)
    gene = field_gene(leaky_conf(), g, g, seed=11)
    np.savez(tmp_path / "inputs.npz", state=state, gene=gene)
    spawn(4, "child_leaky", tmp_path)
    want = {name: np.asarray(jg.compile_step(g, g, block_major=bm)(
        jnp.asarray(state), jnp.asarray(gene), jnp.int32(1)))
        for name, bm in (("block", True), ("tile", False))}
    want["run"] = jg.run(gene, row0=1, col0=1, grid_w=16, progress=False,
                         block_major=True)
    t = leaky_conf()["tile"]
    for rank in range(4):
        got = load(tmp_path, rank)
        h0, w0 = got["offset"]
        assert (h0, w0) == (rank // 2 * 2 * t, rank % 2 * 2 * t)
        for name in ("block", "tile", "run"):
            np.testing.assert_allclose(
                got[name], want[name][h0:h0 + 2 * t, w0:w0 + 2 * t],
                atol=TOY_ATOL, err_msg=f"rank {rank} {name}")


def test_uneven_grid_is_refused():
    """A grid the mesh does not divide is refused, as JAX's sharding
    refuses it (a 3x2 grid over 2x2 devices: ValueError on the CPU)."""
    mesh = tmesh.Mesh((2, 2), ("gr", "gc"), (0, 0), ((None, 2), (None, 1)),
                      torch.device("cpu"))
    gen = tdemo._make_gen(mesh)
    assert gen.sharded and gen.local_block(4, 2) == (0, 0, 2, 1)
    with pytest.raises(ValueError, match="equal blocks"):
        gen.local_block(3, 2)
    with pytest.raises(ValueError, match="not the mesh's"):
        tdemo._make_gen(mesh, device="meta")


def packed_tree():
    """The tiny packed model's tree of seeded weights (JAX's packing of
    test_torch_generator.py's seeded 5D params) and JAX's model."""
    from test_torch_generator import seeded_params

    from tera_mind_tpu.models import unet_packed as jpk
    from tera_mind_tpu.models.unet import TeraUNetConfig as JUNetConfig
    jconf = JUNetConfig(**MKW, dropout=0.0)
    p5 = seeded_params(jconf.make_model(), np.zeros((4, 32, 32, 2),
                                                    np.float32),
                       np.zeros((1,), np.int32),
                       np.zeros((4, 2, 2, 24), np.float32), 2, 2)
    import jax
    p5 = jax.tree.map(lambda a: np.asarray(a, np.float32), p5)
    return jpk.pack_unet_params(p5, jconf), jpk.PackedTeraUNet(jconf)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def tiny_packed_gen(out_dir, mesh=None, device="cpu"):
    """A port generator of the tiny packed model on the saved tree, the
    3-step schedule, GKW geometry."""
    tree = unflatten(dict(np.load(Path(out_dir) / "tree.npz")))
    model = load_jax_params(make_packed_model(TeraUNetConfig(**MKW)), tree)
    sampler = DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                               SamplerConfig(patch_size=32, gn_sz=2))
    return tgen.TeraGenerator(sampler, tgen.ModuleFn(model),
                              tgen.GeneratorConfig(**GKW), device=device,
                              mesh=mesh)


def child_packed(rank, n, port, out_dir):
    rank = int(rank)
    dev = join(rank, n, port)
    gene = np.load(Path(out_dir) / "gene.npy")
    mesh = tmesh.make_mesh(("gr", "gc"), (2, 2), device=dev)
    gen = tiny_packed_gen(out_dir, mesh)
    out = gen.run(gene, row0=1, col0=1, grid_w=16, block_major=True,
                  progress=False)
    save(out_dir, rank, out=out, offset=np.array(gen._local_offset))
    tmesh.shutdown()


@pytest.fixture(scope="module")
def packed_inputs(tmp_path_factory):
    """The tiny packed tree and a 2x2-tile gene grid saved for the ranks,
    and JAX's single-device packed 3-step chain on them."""
    from tera_mind_tpu.diffusion.sampler import DiffusionSampler as JS
    from tera_mind_tpu.diffusion.sampler import SamplerConfig as JSC
    from tera_mind_tpu.diffusion.schedule import spaced_schedule as jss
    from tera_mind_tpu.parallel import generator as jgen
    tmp = tmp_path_factory.mktemp("packed")
    tree, jm = packed_tree()
    np.savez(tmp / "tree.npz", **flatten(tree))
    gene = field_gene(GKW, 2, 2, seed=9)
    np.save(tmp / "gene.npy", gene)
    jg = jgen.TeraGenerator(
        JS(jss("linear", 1000, "ddim3"), JSC(patch_size=32, gn_sz=2)),
        lambda p, xp, tm, rp, p1, p2: jm.apply(p, xp, tm, rp, p1, p2,
                                               decode_original=False),
        jgen.GeneratorConfig(**GKW, noise_backend="torch"), params=tree)
    want = np.asarray(jg.run(gene, row0=1, col0=1, grid_w=16,
                             block_major=True, progress=False))
    return tmp, gene, want


def test_sharded_packed_chain_matches_jax(packed_inputs):
    """The tiny packed model on a 2x2 rank grid (one tile a rank), a
    3-step block-major chain: each rank's tile equals JAX's single-device
    chain within 2e-4 / 1e-3."""
    tmp, _, want = packed_inputs
    spawn(4, "child_packed", tmp)
    for rank in range(4):
        got = load(tmp, rank)
        h0, w0 = got["offset"]
        np.testing.assert_allclose(got["out"],
                                   want[h0:h0 + 64, w0:w0 + 64],
                                   err_msg=f"rank {rank}", **CHAIN_TOL)


# --------------------------------------------------------------------------
# band-parallel streaming and several devices
# --------------------------------------------------------------------------

def t_toy(xp, tm, rp, p1, p2):
    """tests/test_streaming.py's toy model in PyTorch."""
    g = rp.mean(dim=(1, 2, 3))
    eps = 0.1 * xp + 0.01 * g[:, None, None, None]
    return to_collage(eps[:, None], p1, p2)[:, 0], eps


def toy_gen(device="cpu"):
    return tgen.TeraGenerator(
        DiffusionSampler(spaced_schedule("linear", 1000, "ddim3"),
                         SamplerConfig(patch_size=32, gn_sz=2)),
        t_toy, tgen.GeneratorConfig(**TOY), device=device)


def child_band(rank, n, port, out_dir):
    rank = int(rank)
    dev = join(rank, n, port)
    gene = np.load(Path(out_dir) / "gene.npy")
    rows = gene.shape[0]
    r0, nb = tband.band_partition(rows, int(n), rank)
    res = {}
    for k in (1, 2):
        c = tgen.GeneratorConfig(**TOY)
        ex = tband.StripExchange(c.pad + c.patch * (k - 1),
                                 gene.shape[1] * c.tile, c.channels)
        sgen = tstream.StreamingGenerator(toy_gen(dev), tstream.StreamConfig(
            block_rows=2, block_cols=2, progress=False, block_major=True,
            steps_per_window=k))
        res[f"k{k}"] = as_f32(sgen.run(
            nb, gene.shape[1], lambda r, cc: gene[r0 + r, cc], row0=1 + r0,
            col0=1, strip_exchange=ex, rows_above=r0,
            rows_below=rows - r0 - nb).read)
    res["rows"] = np.array([r0, nb])
    save(out_dir, rank, **res)
    tmesh.shutdown()


def test_band_streaming_matches_jax(tmp_path):
    """A 3x3 grid streamed as two bands (2 + 1 tile rows) over two ranks,
    block-major 2x2 windows, K = 1 and K = 2: the bands stacked equal
    JAX's single-device StreamingGenerator run within 1e-5; the windows
    swept over devices=['cpu', 'cpu'] equal the one-device run exactly."""
    from test_torch_streaming import j_toy

    from tera_mind_tpu.diffusion.sampler import DiffusionSampler as JS
    from tera_mind_tpu.diffusion.sampler import SamplerConfig as JSC
    from tera_mind_tpu.diffusion.schedule import spaced_schedule as jss
    from tera_mind_tpu.parallel import generator as jgen
    from tera_mind_tpu.parallel import streaming as jstream
    gene = field_gene({**TOY}, 3, 3, seed=4)
    np.save(tmp_path / "gene.npy", gene)
    spawn(2, "child_band", tmp_path)
    jg = jgen.TeraGenerator(JS(jss("linear", 1000, "ddim3"),
                               JSC(patch_size=32, gn_sz=2)), j_toy,
                            jgen.GeneratorConfig(**TOY,
                                                 noise_backend="torch"))
    for k in (1, 2):
        want = np.asarray(jstream.StreamingGenerator(
            jg, jstream.StreamConfig(block_rows=2, block_cols=2,
                                     progress=False, block_major=True,
                                     steps_per_window=k)).run(
            3, 3, gene, row0=1, col0=1).read)
        got = np.concatenate([load(tmp_path, r)[f"k{k}"] for r in range(2)])
        np.testing.assert_allclose(got, want, atol=TOY_ATOL,
                                   err_msg=f"K={k}")
    one = tstream.StreamingGenerator(toy_gen(), tstream.StreamConfig(
        progress=False, block_major=True)).run(3, 3, gene, row0=1, col0=1)
    two = tstream.StreamingGenerator(toy_gen(), tstream.StreamConfig(
        progress=False, block_major=True), devices=["cpu", "cpu"]).run(
        3, 3, gene, row0=1, col0=1)
    np.testing.assert_array_equal(as_f32(two.read), as_f32(one.read))


# --------------------------------------------------------------------------
# mp_demo and the CLI
# --------------------------------------------------------------------------

def demo_ranks(n, *flags):
    port = tmesh.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tera_mind_tpu_torch.parallel.mp_demo",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(n),
         "--process_id", str(i), "--device", "cpu", "--dist_timeout",
         str(GROUP_TIMEOUT_S), *flags], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
    return outs


@pytest.mark.parametrize("n,flags", [(2, ("--band",)),
                                     (4, ("--mesh_shape", "2,2"))])
def test_mp_demo_ranks_report_ok(n, flags):
    """mp_demo over 2 ranks ((2, 1) mesh) and 4 ranks (2x2): every rank's
    in-memory block, K = 1 band and K = 2 band agree with its own
    single-device recomputation, as JAX's tests/test_multiprocess.py
    checks its demo."""
    outs = demo_ranks(n, *flags)
    assert "backend gloo" in outs[0]
    for i, out in enumerate(outs):
        assert f"[mp_demo] process {i}/{n} ok" in out, out[-3000:]
        assert f"[mp_demo] process {i} band-streaming ok" in out
        assert f"[mp_demo] process {i} band-streaming K2 ok" in out


CLI_ARGV = ["--synthetic", "--hnm", "2", "--wnm", "2", "--hst", "64",
            "--wst", "64", "--tot_epoch", "3", "--ckpt_every", "1",
            "--device", "cpu"]


def cli_gen(out_dir, monkeypatch=None):
    """Point ``cli.generate.build`` at the tiny packed generator: through
    ``monkeypatch`` in the test process, which restores it after the
    test; a rank subprocess, which exits, rebinds it plainly."""
    gen = tiny_packed_gen(out_dir)
    gene = np.load(Path(out_dir) / "gene.npy")
    fake = lambda args: (gen, None, gene, (1, 1))  # noqa: E731
    if monkeypatch is None:
        tcli.build = fake
    else:
        monkeypatch.setattr(tcli, "build", fake)


def child_cli(rank, n, port, out_dir, mode, port2):
    """cli.generate.main as rank ``rank``: a run, then ``--cur_epoch 2``
    from its own spill, each a process group of its own (at ``port`` and
    ``port2``)."""
    rank, n = int(rank), int(n)
    torch.set_num_threads(1)
    cli_gen(out_dir)
    extra = ["--stream"] if mode == "stream" else []
    dist = ["--num_processes", str(n), "--process_id", str(rank),
            "--dist_timeout", str(GROUP_TIMEOUT_S)]
    argv = CLI_ARGV + extra + ["--out_dir", f"{out_dir}/{mode}/ranks"]
    first = tcli.main(argv + dist + ["--coordinator", f"127.0.0.1:{port}"])
    again = tcli.main(argv + dist + ["--cur_epoch", "2", "--coordinator",
                                     f"127.0.0.1:{port2}"])
    save(Path(out_dir) / mode, rank, first=first, again=again)


@pytest.mark.parametrize("mode", ["memory", "stream"])
def test_cli_over_two_ranks_equals_one_process(packed_inputs, mode,
                                               monkeypatch):
    """cli.generate.main over 2 ranks (tiny packed generator): each rank
    writes its band's tiles and its own _p{rank} spill, --cur_epoch
    resumes from it, and the union of the bands equals the one-process
    run (and its resume) within the chain tolerance."""
    tmp, gene, _ = packed_inputs
    (tmp / mode).mkdir()
    outs = spawn(2, "child_cli", tmp, mode, tmesh.free_port())
    assert any("backend gloo" in o for o in outs)
    cli_gen(tmp, monkeypatch)
    extra = ["--stream"] if mode == "stream" else []
    argv = CLI_ARGV + extra + ["--out_dir", str(tmp / mode / "one")]
    want = tcli.main(argv)
    want_again = tcli.main(argv + ["--cur_epoch", "2"])
    ranks = [load(tmp / mode, r) for r in range(2)]
    for key, ref in (("first", want), ("again", want_again)):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in ranks]), ref,
            err_msg=key, **CHAIN_TOL)
    one, two = (TileStore(tmp / mode / d) for d in ("one", "ranks"))
    assert one.names() == two.names() and len(one.names()) == 4
    for name in one.names():
        np.testing.assert_allclose(two.read(name).astype(np.float32),
                                   one.read(name).astype(np.float32),
                                   atol=2e-4 + np.spacing(np.float16(4)))
    spills = sorted(p.name for p in (tmp / mode).iterdir()
                    if "_state" in p.name)
    assert spills == ["one_state_2", "ranks_state_p0_2",
                      "ranks_state_p1_2"], spills
    for r in range(2):      # rank r holds tile row r, from pixel 64(r+1)
        meta = json.loads((tmp / mode / f"ranks_state_p{r}_2" /
                           "manifest.json").read_text())
        assert (meta["t"], meta["rows"], meta["cols"], meta["hst"],
                meta["wst"]) == (2, 1, 2, 64 * (r + 1), 64)


def test_explicit_backend_wins(tmp_path):
    spawn(2, "child_backend", tmp_path)


def test_chip_smoke_requires_the_rank_launches_and_shapes():
    """chip_smoke.py's per-rank launch counts and the shapes it times for
    a rank are scripts/kernel_shapes.py --ranks 2's: in memory each rank's
    1x2-tile block (5x9 patches, one z-window a call, 125 calls and the
    planner's probe), streamed each rank's 2x4-tile band (two 2x2 windows
    of 9x9 patches, 5 z-windows a call, 2 steps), K5 57 a UNet call
    of either, K6 28."""
    import importlib.util

    import chip_smoke as cs
    from tera_mind_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    mem = ks.rank_runs(2, cs.RANK_GRID)
    stream = ks.rank_runs(2, cs.STREAM_GRID, stream=True)
    assert [r["block"] for r in mem] == [(0, 1, 2), (1, 1, 2)]
    assert [r["block"] for r in stream] == [(0, 2, 4), (2, 2, 4)]
    for kind, runs, steps in (("memory", mem, cs.MAIN_STEPS),
                              ("stream", stream, cs.RANK_STREAM_STEPS)):
        for run in runs:
            n1, n2, calls = ks.rank_launches(run, steps)
            k5, k6, k7 = ks.Counter(), ks.Counter(), ks.Counter()
            ks.per_call_shapes(grid=run["patches"], chunk=run["chunk"],
                               k5=k5, k6=k6, k7=k7)
            assert cs.RANK_LAUNCHES[kind] == {
                "rmsnorm": n1, "window_attention": n2,
                "grouped_rmsnorm": sum(k5.values()) * calls,
                "residual": sum(k6.values()) * calls,
                "gated_residual": sum(k7.values()) * calls}
            assert sum(k6.values()) == 28 and sum(k7.values()) == 12
    assert mem[0]["patches"] == (5, 9) and mem[0]["chunk"] == 1
    k1, k2 = ks.per_call_shapes(grid=(5, 9))
    assert set(cs.PATH_SHAPES["rank"][0]) == set(k1)
    assert set(cs.PATH_SHAPES["rank"][1]) == set(k2)
    k1s, k2s = ks.per_call_shapes(grid=stream[0]["patches"],
                                  chunk=stream[0]["chunk"])
    assert set(cs.PATH_SHAPES["stream"][0]) == set(k1s)
    assert set(cs.PATH_SHAPES["stream"][1]) == set(k2s)

"""K5 / K5b, the packed model's ``GroupedRMSNorm`` (``ops/
grouped_rmsnorm_kernel.py``), on the CPU.

The CUDA kernels (``csrc/grouped_rmsnorm.cu``, ``csrc/
grouped_rmsnorm_bwd.cu``) run only on the card, where ``chip_smoke.py``
holds them to their plain versions.  Here: the plain forward against the
JAX module (``tera_mind_tpu/models/unet_packed.py``) for 1-3 segments with
an odd one, Z of 1, 2, 4 and 8, both weight layouts, float32 and bf16 and
a float32 weight of a bf16 x; the autograd Function's gradient against
``jax.grad`` of that module; the dispatcher's routing and the raw
launcher's autograd guard; the variant rule on every shape the paths give
K5; and Python mirrors of the kernels' layouts (the vector variant's lane
plan, the staged variant's plane groups, the dw reduction's fold) held to
the constants in the ``.cu`` sources.
"""

import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tera_mind_tpu.models import unet_packed as jpk
from tera_mind_tpu_torch.models import unet_packed as tpk
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import grouped_rmsnorm_kernel as k5
from tera_mind_tpu_torch.ops.rmsnorm_kernel import vector_group


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: several test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEGMENTS = [(12,), (16, 8, 7), (5, 3), (8, 16)]
ZS = [1, 2, 4, 8]
CASES = [(segs, z, from_5d) for segs in SEGMENTS for z in ZS
         for from_5d in (False, True)]


def inputs(segs, z, from_5d, seed):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((2, 3, 5, z * sum(segs)))).astype(
        np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(
        k5.weight_len(z, segs, from_5d))).astype(np.float32)
    return x, w


def jax_module(segs, z, from_5d):
    return jpk.GroupedRMSNorm(z=z, segments=segs, from_5d=from_5d)


def spacing(a):
    """The bf16 spacing at |a|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
                   - 7)


# ------------------------------------------------------------------ #
# the plain forward against the JAX module                            #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("segs,z,from_5d", CASES)
def test_plain_forward_matches_jax_f32(segs, z, from_5d):
    x, w = inputs(segs, z, from_5d, seed=z + len(segs))
    want = np.asarray(jax_module(segs, z, from_5d).apply(
        {"params": {"weight": w}}, jnp.asarray(x)))
    got = k5.grouped_rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(w),
                                   z, segs, from_5d=from_5d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("segs,z,from_5d", CASES)
@pytest.mark.parametrize("w_dtype", ["bfloat16", "float32"])
def test_plain_forward_matches_jax_bf16(segs, z, from_5d, w_dtype):
    """Both round inv to bf16 and then after each of the two multiplies;
    the float32 statistics are summed in other orders, so at most 1 bf16
    spacing apart.  A float32 weight of a bf16 x (training's master
    weight) is rounded to bf16 first by both."""
    x, w = inputs(segs, z, from_5d, seed=10 + z + len(segs))
    xb = x.astype(ml_dtypes.bfloat16)
    wj = w.astype(ml_dtypes.bfloat16) if w_dtype == "bfloat16" else w
    want = np.asarray(jax_module(segs, z, from_5d).apply(
        {"params": {"weight": wj}}, jnp.asarray(xb))).astype(np.float32)
    wt = torch.from_numpy(w)
    got = k5.grouped_rmsnorm_plain(
        torch.from_numpy(x).bfloat16(),
        wt.bfloat16() if w_dtype == "bfloat16" else wt, z, segs,
        from_5d=from_5d)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= spacing(want)).all()


def test_module_runs_the_dispatcher():
    """``GroupedRMSNorm`` is the dispatcher on its weight and layout: the
    plain version on a CPU tensor, the Function under autograd."""
    m = tpk.GroupedRMSNorm(2, (16, 8, 7), from_5d=True)
    with torch.no_grad():
        m.weight.copy_(1 + 0.1 * torch.arange(31.0) / 31)
    x = torch.from_numpy(inputs((16, 8, 7), 2, True, 3)[0])
    with torch.no_grad():
        y = m(x)
    assert torch.equal(y, k5.grouped_rmsnorm_plain(
        x, m.weight, 2, (16, 8, 7), from_5d=True))
    assert type(m(x).grad_fn).__name__ == "GroupedRMSNormFunctionBackward"


# ------------------------------------------------------------------ #
# the backward against jax.grad of the module                         #
# ------------------------------------------------------------------ #
def jax_grads(segs, z, from_5d, x, w):
    """(dx, dw) of the summed output of JAX's module (float32 sum)."""
    m = jax_module(segs, z, from_5d)

    def loss(p, xx):
        return m.apply(p, xx).astype(jnp.float32).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))({"params": {"weight": w}},
                                            jnp.asarray(x))
    return (np.asarray(gx).astype(np.float32),
            np.asarray(gp["params"]["weight"]).astype(np.float32))


def torch_grads(x, w, z, segs, from_5d):
    xt = x.detach().requires_grad_()
    wt = torch.nn.Parameter(w)
    y = k5.grouped_rmsnorm(xt, wt, z, segs, from_5d=from_5d)
    assert type(y.grad_fn).__name__ == "GroupedRMSNormFunctionBackward"
    y.float().sum().backward()
    return xt.grad, wt.grad


def rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("segs,z,from_5d", CASES)
def test_function_gradient_matches_jax_grad_f32(segs, z, from_5d):
    x, w = inputs(segs, z, from_5d, seed=20 + z + len(segs))
    want_dx, want_dw = jax_grads(segs, z, from_5d, x, w)
    dx, dw = torch_grads(torch.from_numpy(x), torch.from_numpy(w), z, segs,
                         from_5d)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    assert dw.shape == (k5.weight_len(z, segs, from_5d),)
    assert rel(dx.numpy(), want_dx) <= 1e-5
    assert rel(dw.numpy(), want_dw) <= 1e-5


# JAX's autodiff of the bf16 module rounds each step of its backward to
# bf16 (x * sc and its cotangent, the masked sum that carries dsc, the
# rsqrt's derivative, each plane's share); K5b computes the formula in
# float32 and rounds dx once.  So K5b's bf16 dx lies within 1 spacing of
# the float64 gradient of the same bf16 inputs, while JAX's strays by up
# to a few % of max |dx|, and the two are held to each other at that
# level: within BF16_DX_REL of max |dx|.  dw is a float32 sum on both
# sides (JAX casts the bf16 cotangent of w.astype(bf16) to the float32
# parameter), BF16_DW_REL of max |dw|.
BF16_DX_REL = 0.05
BF16_DW_REL = 0.02


@pytest.mark.parametrize("segs,z,from_5d", CASES)
def test_function_gradient_matches_jax_grad_bf16(segs, z, from_5d):
    x, w = inputs(segs, z, from_5d, seed=30 + z + len(segs))
    xb = x.astype(ml_dtypes.bfloat16)
    want_dx, want_dw = jax_grads(segs, z, from_5d, xb, w)
    xt = torch.from_numpy(xb.astype(np.float32)).bfloat16()
    dx, dw = torch_grads(xt, torch.from_numpy(w), z, segs, from_5d)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    # K5b's formula in float64 on the same bf16 inputs and float32 weight:
    # within one bf16 rounding, and a float32 ulp of the formula's terms
    # where they cancel
    exact = k5.grouped_rmsnorm_bwd_plain(
        xt.double(), torch.ones_like(xt, dtype=torch.float64),
        torch.from_numpy(w).double(), z, segs, from_5d=from_5d)[0].numpy()
    assert (np.abs(dx.double().numpy() - exact)
            <= spacing(exact) + 1e-6 * np.abs(exact).max()).all()
    assert rel(dx.float().numpy(), want_dx) <= BF16_DX_REL
    assert rel(dw.numpy(), want_dw) <= BF16_DW_REL


@pytest.mark.parametrize("segs,z,from_5d", [((16, 8, 7), 2, True),
                                            ((5, 3), 4, False),
                                            ((6,), 1, True)])
def test_function_gradient_is_the_plain_gradient(segs, z, from_5d):
    """On the CPU the Function (the plain forward and the plain backward
    formula) passes gradcheck in float64 and equals autograd through
    ``grouped_rmsnorm_plain``."""
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.standard_normal(
        (3, 2, z * sum(segs)))).requires_grad_()
    w = torch.from_numpy(1 + 0.2 * rng.standard_normal(
        k5.weight_len(z, segs, from_5d))).requires_grad_()

    def f(a, b):
        return k5.grouped_rmsnorm(a, b, z, segs, from_5d=from_5d)

    assert torch.autograd.gradcheck(f, (x, w))
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape)))
    got = torch.autograd.grad(f(x, w), (x, w), g)
    want = torch.autograd.grad(k5.grouped_rmsnorm_plain(
        x, w, z, segs, from_5d=from_5d), (x, w), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


# ------------------------------------------------------------------ #
# routing, the autograd guard and the counters                        #
# ------------------------------------------------------------------ #
def test_dispatcher_takes_the_function_only_when_autograd_records():
    x = torch.from_numpy(inputs((8, 16), 2, False, 5)[0])
    w = torch.nn.Parameter(torch.ones(48))
    before = (k5.launches, k5.bwd.launches)
    y = k5.grouped_rmsnorm(x, w, 2, (8, 16))
    assert type(y.grad_fn).__name__ == "GroupedRMSNormFunctionBackward"
    y.sum().backward()
    assert torch.equal(w.grad, k5.grouped_rmsnorm_bwd_plain(
        x, torch.ones_like(x), w, 2, (8, 16))[1])
    with torch.no_grad():
        assert k5.grouped_rmsnorm(x, w, 2, (8, 16)).grad_fn is None
    assert k5.grouped_rmsnorm(x, w.detach(), 2, (8, 16)).grad_fn is None
    assert (k5.launches, k5.bwd.launches) == before   # no launch on a CPU
    meta = torch.empty(2, 48, device="meta")
    with pytest.raises(RuntimeError, match="K5b"):
        k5.grouped_rmsnorm_cuda(meta, torch.nn.Parameter(
            torch.ones(48, device="meta")), 2, (8, 16))
    with pytest.raises(RuntimeError, match="no path"):
        k5.grouped_rmsnorm(meta, w, 2, (8, 16))
    with pytest.raises(ValueError):
        k5.grouped_rmsnorm_plain(x, w, 2, (8, 15))


def test_counters_reset_by_variant():
    k5.reset_launches()
    _build.count_launch(k5, "vector")
    _build.count_launch(k5.bwd, "staged")
    assert (k5.launches, k5.launches_by_variant) == (
        1, {"staged": 0, "vector": 1})
    assert k5.bwd.launches_by_variant == {"staged": 1, "vector": 0}
    k5.reset_launches()
    assert k5.launches == k5.bwd.launches == 0
    assert set(k5.launches_by_variant.values()) == {0}


def test_launcher_checks_its_limits_before_a_launch():
    """What the C entry points refuse is refused in Python first, with no
    library loaded: too many planes or segments, a row over kMaxWidth, a
    weight of the other layout, a g of another dtype."""
    for z, segs, wlen in ((9, (8,), 72), (2, (8, 8, 8, 8), 64),
                          (2, (6200,), 12400), (2, (8, 16), 24)):
        x = torch.zeros(1, z * sum(segs))
        with pytest.raises(ValueError):
            k5.grouped_rmsnorm_cuda(x, torch.ones(wlen), z, segs)
    x = torch.zeros(3, 48)
    with pytest.raises(ValueError, match="is not x's"):
        k5.grouped_rmsnorm_bwd_cuda(x, x.bfloat16(), torch.ones(48), 2,
                                    (8, 16))


# ------------------------------------------------------------------ #
# the variant rule and the layouts the kernels compute                #
# ------------------------------------------------------------------ #
def _kernel_shapes():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    return ks


def path_layouts():
    """Every (z, segments) the generation and training paths give K5 for
    the three presets' and the 8- and 16-slice variants' models."""
    ks = _kernel_shapes()
    out = set()
    for flags in ({}, {"mouse": "609882"}, {"rna_slc": 8},
                  {"mouse": "609889", "patch": 32, "to_hbr": True,
                   "stain": "DAPI", "rna_slc": 16},
                  {"mouse": "609889", "patch": 128, "to_hbr": True}):
        conf = ks.preset_conf(**flags)
        k5s = ks.Counter()
        ks.per_call_shapes(conf=conf, grid=(2, 2), k5=k5s)
        out |= {(z, segs) for _, segs, z in k5s}
    return sorted(out)


def test_variant_rule_on_every_path_layout():
    """bf16 rows whose segments are all multiples of 8 and of at most
    1,024 elements take ``vector`` when aligned; the 229-, 500- and
    81-gene segments' rows and wider rows ``staged``; float32 halves the
    row; misaligned tensors are ``staged``.  Every path layout fits the
    kernels' limits."""
    layouts = path_layouts()
    assert {z for z, _ in layouts} == {2, 4, 8}
    seen = set()
    for z, segs in layouts:
        width = z * sum(segs)
        assert z <= k5.MAX_Z and len(segs) <= k5.MAX_SEGMENTS
        assert width <= k5.MAX_WIDTH
        even = all(c % 8 == 0 for c in segs)
        want = "vector" if even and width <= 1024 else "staged"
        assert k5.grouped_variant(z, segs, 2, True) == want
        assert k5.grouped_variant(z, segs, 4, True) == (
            "vector" if even and width <= 512 else "staged")
        assert k5.grouped_variant(z, segs, 2, False) == "staged"
        seen.add(want)
    assert seen == {"vector", "staged"}
    assert max(z * sum(s) for z, s in layouts) == 8840


def vector_lanes(z, segments, itemsize, from_5d):
    """The vector variant's per-lane plan, as ``VecPlan`` in
    csrc/grouped_rmsnorm.cuh finds it: for lane ``sub`` of a row's G
    lanes, [(vector index, plane, weight vector index)] of its vectors
    sub, sub + G, ...; each vector's elements checked to lie in one plane
    and to read E consecutive weights from a 16-byte vector."""
    e = 16 // itemsize
    width = z * sum(segments)
    g = vector_group(width, itemsize)
    plane, widx = k5.element_planes(z, segments, from_5d)
    out = []
    for sub in range(g):
        mine = []
        for vi in range(sub, width // e, g):
            p, w = plane[vi * e: vi * e + e], widx[vi * e: vi * e + e]
            assert bool((p == p[0]).all()) and int(w[0]) % e == 0
            assert bool((w == w[0] + torch.arange(e)).all()), (vi, p, w)
            mine.append((vi, int(p[0]), int(w[0]) // e))
        out.append(mine)
    return out


@pytest.mark.parametrize("z,segs", [(2, (128, 64, 32)), (2, (64,)),
                                    (4, (128, 128)), (8, (8, 16, 8)),
                                    (1, (8,)), (2, (512,))])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("from_5d", [False, True])
def test_vector_lane_plan(z, segs, itemsize, from_5d):
    """The vector variant's plan (``VecPlan``): each 16-byte vector lies
    in one plane and reads E consecutive weights that start on a
    16-byte vector; a lane holds at most ``kVecMax`` vectors and the
    lanes of a row hold each vector once."""
    width = z * sum(segs)
    if k5.grouped_variant(z, segs, itemsize, True) != "vector":
        assert width * itemsize > k5.VEC_MAX_ROW_BYTES   # the only reason
        return
    lanes = vector_lanes(z, segs, itemsize, from_5d)
    assert len(lanes) == vector_group(width, itemsize)
    assert all(len(v) <= 4 for v in lanes)
    held = sorted(vi for v in lanes for vi, _, _ in v)
    assert held == list(range(width * itemsize // 16))


def staged_visits(z, segs, threads=k5.THREADS):
    """The staged kernels' walk: thread t of plane myz's group visits
    channel j of each segment's part of plane myz for j = t, t + group,
    ... (``csrc/grouped_rmsnorm*.cu``): element -> (thread, plane)."""
    zp = 1 if z <= 1 else 2 if z <= 2 else 4 if z <= 4 else 8
    group = threads // zp
    off, seen = 0, {}
    for c in segs:
        for tid in range(threads):
            myz, t = divmod(tid, group)
            if myz >= z:
                continue
            for j in range(t, c, group):
                e = off + myz * c + j
                assert e not in seen
                seen[e] = (tid, myz)
        off += z * c
    return seen, group


@pytest.mark.parametrize("z", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("segs", [(229,), (512, 256, 229), (81, 8), (7,)])
def test_staged_plane_groups_cover_each_element_once(z, segs):
    """Every element of a row is visited by exactly one thread, of its own
    plane's group (the plane of ``element_planes``), whole warps a group,
    so the plane sums need no test an element and each element's dw sum
    has one owner."""
    seen, group = staged_visits(z, segs)
    plane, _ = k5.element_planes(z, segs, False)
    assert sorted(seen) == list(range(z * sum(segs)))
    assert all(seen[e][1] == int(plane[e]) for e in seen)
    assert group % 32 == 0


def test_dw_fold_of_the_5d_weight():
    """from_5d, element (s, z, j) reads weight channel cum_s + j, so dw
    sums the planes' elements into (Ctot,): ``element_planes``' weight
    index is the fold grouped_bwd_dw_kernel takes (base off_s + j, step
    c_s, Z planes)."""
    z, segs = 4, (16, 8, 7)
    _, widx = k5.element_planes(z, segs, True)
    off = cum = 0
    for c in segs:
        for k in range(cum, cum + c):
            els = [off + k - cum + zz * c for zz in range(z)]
            assert [int(widx[e]) for e in els] == [k] * z
        off += z * c
        cum += c
    assert torch.equal(k5.element_planes(z, segs, False)[1],
                       torch.arange(z * sum(segs)))


def test_staged_blocks_and_bwd_grid():
    """The staged kernels' warps and shared memory a block, and K5b's grid:
    no more blocks than the card holds at once."""
    # 970 bf16 elements: at most 123 words; K5: 3,888 B of weight (972
    # floats) + 8 warps x 1,968 B
    assert k5.staged_smem(970, 2, False) == (8, 3888 + 8 * 1968)
    # K5b: x and g words and the warp's dw sums, 7,824 B a warp
    assert k5.staged_smem(970, 2, True) == (8, 3888 + 8 * 7824)
    # the widest float32 row of K5b: 2,211 words a buffer, one warp
    assert k5.staged_smem(8840, 4, True) == (1, 35360 + 106112)
    assert k5.staged_smem(k5.MAX_WIDTH, 4, True)[1] <= k5.BLOCK_SMEM
    assert k5.bwd_blocks(1, "staged", 970, 2, 132) == 1
    assert k5.bwd_blocks(10 ** 6, "staged", 970, 2, 132) == 3 * 132
    assert k5.bwd_blocks(10 ** 6, "staged", 2506, 2, 132) == 132
    # 448 bf16 channels: 56 vectors, 16 lanes a row, 16 rows a block
    assert k5.bwd_blocks(100, "vector", 448, 2, 132) == 7
    assert k5.bwd_blocks(10 ** 6, "vector", 448, 2, 132) == 2 * 132
    assert k5.bwd_blocks(10 ** 7, "vector", 448, 2, 1000) == \
        k5.BWD_MAX_BLOCKS


def test_wrapper_mirrors_the_sources():
    """The constants the wrapper mirrors are the sources' own, and the
    build compiles both files into the one library."""
    cuh = (_build.CSRC / "grouped_rmsnorm.cuh").read_text()
    fwd = (_build.CSRC / "grouped_rmsnorm.cu").read_text()
    bwd = (_build.CSRC / "grouped_rmsnorm_bwd.cu").read_text()
    for line in (f"constexpr int kMaxZ = {k5.MAX_Z};",
                 f"constexpr int kMaxSegments = {k5.MAX_SEGMENTS};",
                 f"constexpr int kMaxWidth = {k5.MAX_WIDTH};",
                 f"constexpr int kThreads = {k5.THREADS};",
                 "constexpr int kVecMax = 4;",
                 "constexpr int kVecMaxBytes = 32 * kVecMax * 16;",
                 "enum : int { kStaged = 0, kVector = 1 };"):
        assert line in cuh, line
    assert 32 * 4 * 16 == k5.VEC_MAX_ROW_BYTES
    assert k5.VARIANTS == ("staged", "vector")
    assert "constexpr int kMaxBlocks = 8 * 132;" in bwd
    assert k5.BWD_MAX_BLOCKS == 8 * 132
    # the vector kernels' blocks an SM, which the bwd grid's cap assumes
    assert re.search(r"__launch_bounds__\(kThreads, 2\)\s*"
                     r"grouped_bwd_vec_kernel", bwd)
    assert k5.BWD_VEC_BLOCKS_PER_SM == 2
    for src, name in ((fwd, "grouped_staged_kernel"),
                      (bwd, "grouped_bwd_staged_kernel")):
        assert re.search(r"__launch_bounds__\(32 \* kStagedMaxWarps\)\s*"
                         + name, src)
    assert f"constexpr int kStagedMaxWarps = {k5.STAGED_MAX_WARPS};" in cuh
    assert f"constexpr int kSmSmem = {k5.SM_SMEM};" in cuh
    assert "const int by_smem = kSmSmem / (staged_smem<T>(w, bwd) + 1024);" \
        in cuh and "const int by_warps = 64 / staged_warps<T>(w, bwd);" in cuh
    assert f"constexpr int kMaxBlockSmem = {k5.BLOCK_SMEM};" in (
        _build.CSRC / "common.cuh").read_text()
    assert "while (g < 32 && g * kVecMax < nvec) g *= 2;" in cuh
    assert "#include \"rmsnorm_words.cuh\"" in cuh
    for src in (fwd, bwd):
        assert "#include \"grouped_rmsnorm.cuh\"" in src
        assert "unet_packed.py:85-108" in src
    assert {p.name for p in _build.sources()} >= {
        "grouped_rmsnorm.cu", "grouped_rmsnorm_bwd.cu",
        "grouped_rmsnorm.cuh"}
    assert len(_build.SIGNATURES["tmt_grouped_rmsnorm"]) == 15
    assert len(_build.SIGNATURES["tmt_grouped_rmsnorm_bwd"]) == 18

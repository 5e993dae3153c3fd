"""The backward kernels' variants, K1b (``csrc/rmsnorm_bwd.cu``) and K2b
(``csrc/attention_bwd.cu``), on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each
variant against its plain version there).  Here: which variant each shape
of ``chip_smoke.py`` takes, the Python mirrors of the kernels' layouts
and grids against the constants in the sources, the launch counters by
variant, and the rounding decisions of the tensor-core variants: an
emulation of K2b's split-bf16 products stays inside ``chip_smoke.py``'s
bf16 gate against the plain version and against the JAX rule ``_bwd``,
where rounding p and ds once to bf16 does not, and so does an emulation
of K2's ``tensor_core_tiled`` sums against the plain forward and JAX's.
"""

import functools
import importlib.util

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tera_mind_tpu.ops.attention_kernel import _attention_xla
from tera_mind_tpu.ops.attention_kernel import _bwd as jax_attention_bwd
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import attention_kernel as k2
from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the emulations' float64 chunk
    products are small, and several test workers with full thread pools
    would oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_shapes():
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    return ks


# ------------------------------------------------------------------ #
# which variant each shape takes                                      #
# ------------------------------------------------------------------ #
K2B_WANT = {(512, 128, 256): "wgmma", (128, 128, 256): "wgmma",
            (512, 32, 512): "wgmma", (5, 100, 48): "tensor_core",
            (3, 17, 130): "cuda_core", (2, 512, 512): "wgmma",
            (7, 100, 256): "wgmma", (3, 200, 128): "wgmma"}


@pytest.mark.parametrize("b,n,d", cs.TRAIN_K2_SHAPES + cs.K2B_EDGE)
def test_attention_bwd_variant_of_every_chip_smoke_shape(b, n, d):
    """bf16 training shapes take Hopper's wgmma, and so do the ragged
    edges (7, 100, 256) (fused) and (3, 200, 128) (two-pass) and N = D =
    512 (blocked); (5, 100, 48) (D not a multiple of 128) the tensor cores
    through mma.sync; D = 130 (not a multiple of 16) stays on CUDA cores,
    and so do float32 and misaligned tensors."""
    assert set(K2B_WANT) == set(cs.TRAIN_K2_SHAPES + cs.K2B_EDGE)
    assert k2.attention_bwd_variant(n, d, BF16, True) == K2B_WANT[(b, n, d)]
    assert k2.attention_bwd_variant(n, d, F32, True) == "cuda_core"
    assert k2.attention_bwd_variant(n, d, BF16, False) == "cuda_core"


@pytest.mark.parametrize("n,c", [s[:2] for s in cs.TRAIN_K1_SHAPES
                                 + cs.K1B_EDGE])
def test_rmsnorm_bwd_variant_of_every_chip_smoke_shape(n, c):
    """K1's rule: vector for C % 8 == 0 and a row of at most 2,048 bytes
    with x, g, w, dx aligned, else strided (the odd C of the gene
    concats, C = 2,050, float32 rows over 512 channels, misaligned)."""
    vec_bf16 = c % 8 == 0 and c <= 1024
    assert k1.rmsnorm_bwd_variant(c, 2, True) == (
        "vector" if vec_bf16 else "strided")
    assert k1.rmsnorm_bwd_variant(c, 4, True) == (
        "vector" if c % 8 == 0 and c <= 512 else "strided")
    assert k1.rmsnorm_bwd_variant(c, 2, False) == "strided"
    if (n, c) in cs.TRAIN_K1_SHAPES:
        assert vec_bf16 == (c not in (485, 741, 997, 1253))


@pytest.mark.parametrize("packed,path", [(False, "5d"), (True, "packed")])
def test_chip_smoke_requires_the_training_counts_by_variant(packed, path):
    """chip_smoke.py's per-step K1b / K2b launches by variant are what
    scripts/kernel_shapes.py --train attributes to the variants, and add
    up to its per-step totals."""
    ks = _kernel_shapes()
    by = ks.train_bwd_variants(packed)
    assert by == cs.TRAIN_BWD_VARIANTS[path]
    assert sum(by["rmsnorm_bwd"].values()) == \
        cs.TRAIN_LAUNCHES[path]["rmsnorm"]
    assert sum(by["grouped_rmsnorm_bwd"].values()) == \
        cs.TRAIN_LAUNCHES[path]["grouped_rmsnorm"]
    assert by["window_attention_bwd"] == {
        "cuda_core": 0, "tensor_core": 0, "tensor_core_tiled": 0,
        "wgmma": cs.TRAIN_LAUNCHES[path]["window_attention"]}


@pytest.mark.parametrize("method", ["patch-dm", "sinf"])
def test_chip_smoke_requires_the_baseline_training_counts(method):
    """A baseline's training step launches K1 and K1b only in the RNA
    tower's gene block (q_norm, norm2; vector, at a shape phase 4 checks)
    and no K2 or K2b: chip_smoke.py's counts are scripts/kernel_shapes.py
    --train --method's."""
    ks = _kernel_shapes()
    k1_shapes, k2_shapes = ks.train_shapes(method=method)
    assert not k2_shapes
    assert set(k1_shapes) <= set(cs.TRAIN_K1_SHAPES)
    assert cs.TRAIN_LAUNCHES[method] == {
        "rmsnorm": sum(k1_shapes.values()) * ks.TRAIN_ACCUM,
        "window_attention": 0, "grouped_rmsnorm": 0, "residual": 0,
        "gated_residual": 0} == {
        "rmsnorm": 4, "window_attention": 0, "grouped_rmsnorm": 0,
        "residual": 0, "gated_residual": 0}
    assert ks.train_bwd_variants(method=method) == \
        cs.TRAIN_BWD_VARIANTS[method]


# ------------------------------------------------------------------ #
# the mirrors of the kernels' layouts and grids                       #
# ------------------------------------------------------------------ #
def test_tensor_core_bwd_smem_matches_the_kernels_layout():
    src = (_build.CSRC / "attention_bwd.cu").read_text()
    assert f"kTcRows = {k2.TC_ROWS};" in src
    assert f"kTcMaxN = {k2.TC_MAX_N};" in src
    assert "bwd_tc_layout(128, 256).dq_bytes == 204288" in src
    assert "bwd_tc_layout(128, 256).kv_bytes == 206336" in src
    assert k2.bwd_tc_smem_bytes(128, 256) == (204_288, 206_336)
    # N = 32: one 32-row tile, ds over q and g; the dk/dv pass's p^T and
    # ds^T fit over the k and v tiles
    assert k2.bwd_tc_smem_bytes(32, 512) == (
        2 * 4 * 32 * 520 + 4 * 6 * 64, 2 * 4 * 32 * 520 + 4 * 3 * 32)
    # N = 100 pads to 112 rows; ds (64 x 120, twice) does not fit over the
    # 64 x 56 q and g tiles, so it goes after v
    assert k2.bwd_tc_smem_bytes(100, 48) == (
        2 * (2 * 64 * 56 + 2 * 112 * 56 + 2 * 64 * 120) + 4 * 6 * 64,
        2 * (2 * 112 * 56 + 4 * 64 * 120) + 4 * 3 * 112)
    # D = 512 at N = 128: k and v alone fill 266 KB; the tiled variant
    # took it, and takes it when forced (wgmma takes it by the rule)
    assert min(k2.bwd_tc_smem_bytes(128, 512)) > k2.SMEM_LIMIT
    assert k2.replaced_bwd_variant(128, 512) == "tensor_core_tiled"
    assert k2.replaced_bwd_variant(64, 512) == "tensor_core_tiled"
    assert k2.attention_bwd_variant(128, 512, BF16, True) == "wgmma"
    assert k2.attention_bwd_variant(16, 16, BF16, True) == "tensor_core"


def test_tiled_bwd_smem_matches_the_kernels_layout():
    """K2b's tensor_core_tiled layout mirrors against the constants and
    the static_assert of csrc/attention_bwd.cu, and both passes of every
    N <= 512, D in 16 .. 512 (multiples of 16) within a block's shared
    memory."""
    src = (_build.CSRC / "attention_bwd.cu").read_text()
    assert "for (int r = d <= 256 ? 64 : 32; r >= 32; r /= 2)" in src
    assert "dq_tiled_layout(512, 128).bytes == 210432" in src
    assert "dq_tiled_layout(512, 512).bytes == 231936" in src
    assert "dq_tiled_layout(256, 256).r == 64" in src
    assert "dq_tiled_layout(256, 256).bytes == 200704" in src
    assert "kv_tiled_layout(256).bytes == 156416" in src
    assert "kv_tiled_layout(512).kr == 32" in src
    assert "kv_tiled_layout(512).qt == 32" in src
    assert "const int kr0 = 16 * (tl::kWarps / ((d + 63) / 64));" in src
    assert "const int kr = kr0 > 64 ? 64 : kr0;" in src
    assert "constexpr int kTlSlots = 2;" in src
    assert "constexpr int kWarps = 16;" in (
        _build.CSRC / "attention_tiled.cuh").read_text()
    # dq pass: 32 rows at N = 512 (64 rows' logits and dp alone are 264
    # KB), 64 at (256, 256)
    assert k2.dq_tiled_layout(512, 128) == (32, 128, 2, 210_432)
    assert k2.dq_tiled_layout(512, 512) == (32, 32, 2, 231_936)
    assert k2.dq_tiled_layout(256, 256) == (64, 32, 2, 200_704)
    # the dk/dv pass: 64, 64, 32 key rows at D = 128, 256, 512 (a warp's
    # up to two 16 x 64 tiles of dv and dk: 64 f32 a thread)
    assert [k2.kv_tiled_layout(d)[:3] for d in (128, 256, 512)] == [
        (64, 64, 2), (64, 32, 2), (32, 32, 2)]
    assert k2.kv_tiled_layout(256)[3] == 156_416
    for d in range(16, k2.MAX_D + 1, 16):
        kr = k2.kv_tiled_layout(d)[0]
        assert 2 * (kr // 16) * -(-d // 64) <= 2 * 16, d  # kTlSlots x warps
    worst = max(max(k2.bwd_tiled_smem_bytes(n, d))
                for n in range(1, k2.MAX_N + 1)
                for d in range(16, k2.MAX_D + 1, 16))
    assert worst <= k2.SMEM_LIMIT


def test_bwd_entry_points_take_the_variant():
    """Both C entry points take a variant code after the dtype, and the
    ctypes signatures pass it."""
    attn = (_build.CSRC / "attention_bwd.cu").read_text()
    norm = (_build.CSRC / "rmsnorm_bwd.cu").read_text()
    assert "float scale, int dtype, int variant," in attn
    assert ("enum : int { kCudaCore = 0, kTensorCore = 1, kTensorCoreTiled"
            " = 2,\n             kWgmma = 3 };") in attn
    assert "int dtype, int variant, void* stream)" in norm
    assert "enum : int { kStrided = 0, kVector = 1 };" in norm
    assert k2.VARIANTS == ("cuda_core", "tensor_core", "tensor_core_tiled",
                           "wgmma")
    assert k2.BWD_VARIANTS == k2.VARIANTS   # K2b's wgmma at K2's code 3
    assert "if (variant == kWgmma)\n      return attention_bwd_wgmma(" in attn
    assert k1.VARIANTS == ("strided", "vector")
    assert len(_build.SIGNATURES["tmt_window_attention_bwd"]) == 15
    assert len(_build.SIGNATURES["tmt_rmsnorm_bwd"]) == 13


def test_k1b_grid_and_lane_groups_mirror_the_kernel():
    src = (_build.CSRC / "rmsnorm_bwd.cu").read_text()
    assert "while (g < 32 && g * kVecMax < nvec) g *= 2;" in src
    assert f"kVecThreads = {k1.BWD_VEC_THREADS};" in src
    assert f"kVecMax = {k1.VEC_MAX};" in src
    assert "kLaneRowMaxPer = 40;" in src and "kStridedMaxPer = 64;" in src
    assert k1.BWD_LANE_ROW_MAX_C == 32 * 40
    assert k1.BWD_REGISTER_MAX_C == 32 * 64
    # C = 64 bf16: 8 vectors, 2 lanes a row; C = 1,024: 32 lanes
    assert [k1.vector_group(c, 2) for c in (8, 64, 96, 256, 512, 1024)] \
        == [1, 2, 4, 8, 16, 32]
    assert k1.vector_group(512, 4) == 32
    assert k1.bwd_blocks(10 ** 6, 128, 264) == 264
    assert k1.bwd_blocks(4096, 16, 264) == 256
    assert k1.bwd_blocks(1, 128, 264) == 1
    assert k1.bwd_blocks(10 ** 6) == k1.BWD_MAX_BLOCKS   # the defaults


def test_backward_counters_count_by_variant_and_reset():
    assert set(k1.bwd.launches_by_variant) == set(k1.VARIANTS)
    assert set(k2.bwd.launches_by_variant) == set(k2.BWD_VARIANTS)
    _build.count_launch(k2.bwd, "tensor_core")
    _build.count_launch(k2.bwd, "tensor_core")
    _build.count_launch(k2.bwd, "cuda_core")
    _build.count_launch(k1.bwd, "vector")
    assert k2.bwd.launches >= 3 and k2.bwd.launches_by_variant[
        "tensor_core"] >= 2 and k1.bwd.launches_by_variant["vector"] >= 1
    k2.reset_launches()
    k1.reset_launches()
    for mod in (k1, k2):
        assert mod.bwd.launches == 0 and mod.launches == 0
        assert set(mod.bwd.launches_by_variant.values()) == {0}
    # the CPU path of the dispatchers launches nothing
    x = torch.randn(6, 16, requires_grad=True)
    k1.rmsnorm(x, torch.ones(16)).sum().backward()
    q = torch.randn(2, 8, 16, requires_grad=True)
    k2.window_attention(q, q, q, 0.25).sum().backward()
    assert (k1.bwd.launches, k2.bwd.launches) == (0, 0)


def test_perf_md_norm_step_bounds_are_kernel_shapes():
    """PERF.md's byte bounds a training step of K1 and K1b ``strided``
    are scripts/kernel_shapes.py --train's (bf16, kernel_work's bytes over
    the H100's 3.35 TB/s), for the 5D step of 638850, of 609882 and of
    patch 128 at batch 8."""
    ks = _kernel_shapes()
    text = " ".join((_build.PKG.parent / "PERF.md").read_text().split())
    for label, conf in (
            ("638850", ks.preset_conf()),
            ("609882", ks.preset_conf("609882")),
            ("patch 128", ks.preset_conf("609889", 128, True, batch=8))):
        k1_shapes, _ = ks.train_shapes(conf=conf)
        step = ks.norm_step_bytes(k1_shapes, conf.accum_batches)
        ms = {k: step[f"{k} strided"] / ks.H100_BYTES_PER_S * 1e3
              for k in ("K1", "K1b")}
        want = (f"{label}: K1 `strided` {ms['K1']:.4f} ms, K1b `strided` "
                f"{ms['K1b']:.4f} ms")
        assert want in text, want


# ------------------------------------------------------------------ #
# the sum order of K1's and K1b's strided variants                    #
# ------------------------------------------------------------------ #
H100_BLOCKS = 2 * 132     # rmsnorm_kernel._resident_blocks on an H100


def _lane_order(rows, c, itemsize, lanes):
    """(lane, place in the lane's sum) of each (row, channel) of a tensor
    that starts on 16 bytes: by the word scheme on a row's ``lanes`` lanes
    (csrc/rmsnorm_words.cuh: lane l holds the row's words l, l + lanes,
    ... and sums its elements in word order), or, ``lanes`` 0, by channels
    lane, lane + 32, ... (the lane rows and the second read)."""
    ch = np.arange(c)[None, :].repeat(rows, 0)
    if not lanes:
        return ch % 32, ch // 32
    e = 16 // itemsize     # csrc/rmsnorm_words.cuh kWordBytes
    q = (np.arange(rows)[:, None] * c) % e + ch    # place from word k0
    kk, j = np.divmod(q, e)
    return kk % lanes, (kk // lanes) * e + j


def _warp_fma_sums(a, b, lane, place, lanes=32):
    """Each row's sum of a b as its lanes take it: each lane's fmaf in
    its order (float32, one rounding), then the shuffle tree (xor
    lanes / 2, ..., 2, 1)."""
    rows, c = a.shape
    A = np.zeros((rows, lanes, place.max() + 1), np.float32)
    B = np.zeros_like(A)
    r = np.arange(rows)[:, None].repeat(c, 1)
    A[r, lane, place], B[r, lane, place] = a, b
    acc = np.zeros((rows, lanes), np.float32)
    for k in range(A.shape[-1]):
        acc = (acc.astype(np.float64) + A[..., k].astype(np.float64)
               * B[..., k]).astype(np.float32)
    o = lanes // 2
    while o:
        acc = acc + acc[:, np.arange(lanes) ^ o]
        o //= 2
    return acc[:, :1]


def _inv(ss, c, eps=1e-6):
    return (1.0 / np.sqrt(ss / np.float32(c) + np.float32(eps))).astype(
        np.float32)


def _k1_emulated(x, w, lanes):
    """K1 strided: the row's sum of squares in the kernel's order, then
    the TPU kernel's roundings (csrc/rmsnorm.cu apply)."""
    xf = x.float().numpy()
    lane, place = _lane_order(*x.shape, x.element_size(), lanes)
    inv = _inv(_warp_fma_sums(xf, xf, lane, place, lanes or 32), x.shape[1])
    xt, it = x.float(), torch.from_numpy(inv)
    if x.dtype == BF16:
        return ((xt * it.to(BF16).float()).to(BF16).float()
                * w.to(BF16).float()).to(BF16)
    return w * (xt * it)


def _k1b_emulated(x, g, w, words):
    """K1b strided: the row's two sums in the kernel's order, dx and each
    row's dw term in float32, dw summed over a warp's rows, the block's
    warps, and the blocks by rmsnorm_bwd_dw_kernel's groups, in order."""
    rows, c = x.shape
    xf, gf, wf = x.float().numpy(), g.float().numpy(), w.numpy()
    lane, place = _lane_order(rows, c, x.element_size(), 32 if words else 0)
    gw = gf * wf
    inv = _inv(_warp_fma_sums(xf, xf, lane, place), c)
    m = _warp_fma_sums(gw, xf, lane, place) / np.float32(c)
    dx = inv * gw - inv * inv * inv * xf * m
    term = gf * xf * inv
    blocks = k1.bwd_blocks(rows, k1.BWD_WARPS, H100_BLOCKS)
    warp = np.zeros((blocks, k1.BWD_WARPS, c), np.float32)
    for r in range(rows):   # grid-stride: row = b * warps + w + t * stride
        b, w_ = divmod(r % (blocks * k1.BWD_WARPS), k1.BWD_WARPS)
        warp[b, w_] += term[r]
    partial = np.zeros((blocks, c), np.float32)
    for w_ in range(k1.BWD_WARPS):
        partial += warp[:, w_]
    dw = np.zeros(c, np.float32)
    for grp in range(8):     # rmsnorm_bwd_dw_kernel's kDwGroups
        s = np.zeros(c, np.float32)
        for b in range(grp, blocks, 8):
            s += partial[b]
        dw += s
    return torch.from_numpy(dx).to(x.dtype), torch.from_numpy(dw)


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("c", [485, 741, 1012, 1524, 2047])
def test_strided_sum_orders_keep_the_gates(c, dt):
    """An emulation of the strided variants' sums, in the order of the
    design each shape takes (the 16-byte words, or channels lane, lane +
    32, ...), meets chip_smoke.py's gates against the plain versions: K1
    4 bf16 spacings (float32 1e-5), K1b dx 2 spacings with at most 1 % not
    bit-equal (float32 1e-5 of max), dw 1e-4 of max."""
    gen = torch.Generator().manual_seed(c)
    x, g = (torch.randn(64, c, generator=gen).to(dt) for _ in range(2))
    w = 1 + 0.1 * torch.randn(c, generator=gen)
    itemsize = x.element_size()
    # K1's lanes a row (csrc/rmsnorm.cu launch_strided): 16 up to 2 words
    # a lane of a warp, 32 up to the register limit, else the second read
    span = -(-(16 - itemsize + c * itemsize) // 16)
    lanes = (0 if c * itemsize > k1.REGISTER_MAX_ROW_BYTES else
             16 if span <= 64 else 32)
    y = _k1_emulated(x, w.to(dt), lanes)
    ref = k1.rmsnorm_plain(x, w.to(dt))
    if dt == BF16:
        assert cs.ulp_err(y, ref) <= cs.K1_MAX_ULP
    else:
        assert float((y - ref).abs().max()) <= 1e-5
    bwd_words = itemsize == 2 and k1.BWD_LANE_ROW_MAX_C < c <= \
        k1.BWD_REGISTER_MAX_C
    dx, dw = _k1b_emulated(x, g, w, bwd_words)
    rdx, rdw = k1.rmsnorm_bwd_plain(x, g, w)
    cs.require_bwd(dx, rdx, f"K1b emulated {c} {dt}")
    assert cs.rel_err(dw, rdw) <= cs.BWD_DW_TOL


# ------------------------------------------------------------------ #
# the rounding decision of K2b tensor_core                            #
# ------------------------------------------------------------------ #
def _split(x):
    """x as the split pair (hi, lo) of bf16 values (held as float)."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def _rounded(x):
    return (x.to(BF16).float(),)


def _mma_sum(parts, b):
    """(sum of parts) @ b as the kernel sums it: along the reduction axis
    in chunks of 16, each operand part's exact chunk product rounded to
    float32 and added to one float32 accumulator in order."""
    acc = torch.zeros(parts[0].shape[:-1] + b.shape[-1:])
    for k0 in range(0, b.shape[-2], 16):
        for a in parts:
            acc = acc + torch.matmul(a[..., k0:k0 + 16].double(),
                                     b[..., k0:k0 + 16, :].double()).float()
    return acc


def _k2b_emulated(q, k, v, g, scale, operands):
    """K2b with bf16 mma operands: q k^T and g v^T on the bf16 inputs, p
    and ds in float32 as the JAX rule has them, and every product with p
    or ds on ``operands(x)`` (the split pair, or one rounding)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.softmax(_mma_sum((qf,), kf.transpose(-1, -2)) * scale, -1)
    dp = _mma_sum((gf,), vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dv = _mma_sum(operands(p.transpose(-1, -2)), gf)
    dq = _mma_sum(operands(ds), kf) * scale
    dk = _mma_sum(operands(ds.transpose(-1, -2)), qf) * scale
    return tuple(t.to(BF16) for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _emulation(n, d, peaked):
    """(inputs, plain version's outputs, JAX _bwd's outputs) of 8 batch
    indices in bf16, randn or peaked as chip_smoke.py draws them."""
    g_ = torch.Generator().manual_seed(100 * n + d + peaked)
    q, k, v = cs.k2_inputs(g_, 8, n, d, BF16, "cpu", peaked)
    g = torch.randn(8, n, d, generator=g_).to(BF16)
    plain = k2.attention_bwd_plain(q, k, v, g, 1.0 / d)
    as_jax = [jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
              for t in (q, k, v, g)]
    jax_out = jax_attention_bwd(1.0 / d, tuple(as_jax[:3]), as_jax[3])
    jax_out = tuple(torch.from_numpy(np.asarray(t).astype(np.float32))
                    .to(BF16) for t in jax_out)
    return (q, k, v, g), plain, jax_out


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("n,d", [(128, 256), (32, 512), (512, 128),
                                 (128, 512), (256, 256)])
def test_split_bf16_products_keep_the_jax_rounding(n, d, peaked):
    """The split pair hi = bf16(x), lo = bf16(x - hi), two products into
    one float32 accumulator, passes chip_smoke.py's bf16 gate (2 spacings
    at max |ref|, at most 1 % not bit-equal) against the plain version
    and against the JAX rule, with about a quarter of a percent of the
    outputs one rounding step apart."""
    (q, k, v, g), plain, jax_out = _emulation(n, d, peaked)
    got = _k2b_emulated(q, k, v, g, 1.0 / d, _split)
    for name, out, ref, jref in zip(("dq", "dk", "dv"), got, plain, jax_out):
        _, spacings, share = cs.require_k2(out, ref, f"split {name}")
        assert spacings <= 1.0 and share <= 5e-3, (name, spacings, share)
        _, spacings, share = cs.require_k2(out, jref, f"split {name} jax")
        assert spacings <= 1.0 and share <= 5e-3, (name, spacings, share)
        # the plain version itself is the JAX rule's bits up to its sums
        _, _, share = cs.k2_agreement(ref, jref)
        assert share <= 5e-3


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("n,d", [(128, 256), (32, 512)])
def test_one_bf16_rounding_of_p_and_ds_breaks_the_gate(n, d, peaked):
    """Rounding p and ds once to bf16 as mma operands, the cheaper design,
    changes a third or more of dq, dk and dv: the gate refuses it, which
    is why K2b's tensor-core variant splits them."""
    (q, k, v, g), plain, _ = _emulation(n, d, peaked)
    got = _k2b_emulated(q, k, v, g, 1.0 / d, _rounded)
    for name, out, ref in zip(("dq", "dk", "dv"), got, plain):
        assert cs.k2_agreement(out, ref)[2] > 0.3, name
        with pytest.raises(cs.SmokeFailure):
            cs.require_k2(out, ref, f"rounded {name}")


# ------------------------------------------------------------------ #
# the sums of K2 tensor_core_tiled                                    #
# ------------------------------------------------------------------ #
def _k2_tiled_emulated(q, k, v, scale):
    """K2's tensor_core_tiled sums (csrc/attention.cu): each K tile's
    logits q k^T, bf16 products summed in mma chunks of 16 along D, times
    scale into the rows' f32 logits; the exact softmax over all N (row
    max, exp, sum, divide); p rounded once to bf16; p v over the V tiles
    in chunks of 16 keys into one f32 accumulator (the tiles' kt rows are
    a multiple of 16, so the chunks run in key order), rounded once."""
    n, d = q.shape[-2:]
    kt = k2.tiled_layout(n, d)[1]
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = torch.cat([_mma_sum((qf,), kf[:, j0:j0 + kt].transpose(-1, -2))
                   for j0 in range(0, n, kt)], -1) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(BF16).float()
    return _mma_sum((p,), vf).to(BF16)


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("n,d", [(512, 128), (128, 512), (256, 256)])
def test_tiled_forward_sums_keep_the_k2_gate(n, d, peaked):
    """An emulation of K2 tensor_core_tiled's sums at the presets' shapes
    it took before wgmma (and takes when forced, as chip_smoke.py
    --attention times it) passes chip_smoke.py's bf16 gate (2 spacings at
    max |ref|, at most 1 % not bit-equal) against the plain version and
    against JAX's reference ``_attention_xla``."""
    assert k2.replaced_variant(n, d) == "tensor_core_tiled"
    g_ = torch.Generator().manual_seed(300 * n + d + peaked)
    q, k, v = cs.k2_inputs(g_, 8, n, d, BF16, "cpu", peaked)
    got = _k2_tiled_emulated(q, k, v, 1.0 / d)
    ref = k2.attention_plain(q, k, v, 1.0 / d)
    as_jax = [jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
              for t in (q, k, v)]
    jref = torch.from_numpy(np.asarray(_attention_xla(*as_jax, 1.0 / d))
                            .astype(np.float32)).to(BF16)
    for what, want in (("plain", ref), ("jax", jref)):
        _, spacings, share = cs.require_k2(got, want, f"tiled {what}")
        assert spacings <= 1.0 and share <= 5e-3, (what, spacings, share)


@pytest.mark.parametrize("preset", list(cs.PRESETS) + list(
    cs.PRESET_KERNELS_ONLY))
def test_presets_launch_no_cuda_core_attention(preset):
    """At full width, scripts/kernel_shapes.py predicts no K2 or K2b
    launch on ``cuda_core`` for any preset phase 19 runs or checks: the
    2x2 generation chain (packed and 5D) and a training step (5D and
    packed) take the tensor cores, all through wgmma since K2b's wgmma
    variant (the tiled variant, which took N > 128 or D = 512 at N = 128,
    takes none of them)."""
    ks = _kernel_shapes()
    flags = cs.PRESETS.get(preset) or cs.PRESET_KERNELS_ONLY[preset]
    conf = cs.preset_conf(ks, flags)
    preds = [ks.chain_prediction(conf, packed=packed)
             for packed in (True, False)]
    for packed in (False, True):
        conf.packed_compute = packed
        preds.append(ks.train_prediction(conf))
    tiled = wgmma = 0
    for pred in preds:
        for name in ("window_attention", "window_attention_bwd"):
            if name in pred:
                by = pred[name]["by_variant"]
                assert by["cuda_core"] == 0, (preset, name, by)
                tiled += by["tensor_core_tiled"]
                wgmma += by["wgmma"]
                assert by["wgmma"] == pred[name]["launches"], (preset, by)
    assert tiled == 0 and wgmma > 0, preset


# ------------------------------------------------------------------ #
# K2b wgmma: its rule, its plan and its order of sums                 #
# ------------------------------------------------------------------ #
# (B, N, D) of every K2b launch on the training paths: 638850 (phase 4),
# a data-parallel rank of 2 (phase 18), patch 128 at batch 8 and 32, 16
# and 8 RNA slices (phase 19), with the mma.sync variant each took before
K2B_PATH_SHAPES = {
    (512, 128, 256): "tensor_core", (128, 128, 256): "tensor_core",
    (512, 32, 512): "tensor_core", (256, 128, 256): "tensor_core",
    (64, 128, 256): "tensor_core", (256, 32, 512): "tensor_core",
    (128, 128, 512): "tensor_core_tiled", (32, 128, 512): "tensor_core_tiled",
    (512, 128, 512): "tensor_core_tiled",
    (512, 512, 128): "tensor_core_tiled", (128, 512, 128): "tensor_core_tiled",
    (512, 256, 256): "tensor_core_tiled", (128, 256, 256): "tensor_core_tiled",
    (512, 64, 512): "tensor_core_tiled"}


def test_k2b_path_shapes_hold_the_smokes_training_shapes():
    """The table holds chip_smoke.py's training shapes (phase 4) and a
    data-parallel rank's (phase 18); phase 19's presets give the other
    eight (scripts/kernel_shapes.py, held in test_torch_presets.py)."""
    assert len(K2B_PATH_SHAPES) == 14
    assert set(cs.TRAIN_K2_SHAPES) <= set(K2B_PATH_SHAPES)
    assert set(cs.train_rank_shapes(2)[1]) <= set(K2B_PATH_SHAPES)


@pytest.mark.parametrize("b,n,d", sorted(K2B_PATH_SHAPES))
def test_wgmma_bwd_takes_every_path_shape(b, n, d):
    """K2b's rule names wgmma for every bf16 path shape with aligned
    tensors; its plan fits a block's shared memory with a ring deep enough
    that a consumer can issue one tile's logits before it releases a slot
    (the two-pass design's s and dp slabs, the fused design's two-slab
    slots); the mma.sync variant it replaced stays reachable by a forced
    variant; float32 and misaligned tensors stay on CUDA cores."""
    assert k2.wgmma_bwd_takes(n, d)
    assert k2.attention_bwd_variant(n, d, BF16, True) == "wgmma"
    assert k2.replaced_bwd_variant(n, d) == K2B_PATH_SHAPES[(b, n, d)]
    assert k2.attention_bwd_variant(n, d, F32, True) == "cuda_core"
    assert k2.attention_bwd_variant(n, d, BF16, False) == "cuda_core"
    lay = k2.wgmma_bwd_layout(n, d)
    assert lay["smem"] <= k2.SMEM_LIMIT
    assert lay["fused"] == (n <= 128)
    if lay["fused"]:
        assert lay["stages"] >= 2 and lay["bpu"] == (1 if n > 64 else 2)
        assert lay["halves"] * 2 == lay["slabs"]     # D % 128 == 0
    else:
        assert lay["stages"] >= 2 * lay["slabs"] // lay["sps"]
        assert lay["sps"] == (2 if d == 128 else 1)


@pytest.mark.parametrize("n,d,want", [
    (100, 48, "tensor_core"), (128, 64, "tensor_core"),
    (200, 64, "tensor_core_tiled"), (256, 192, "tensor_core_tiled"),
    (17, 130, "cuda_core")])
def test_wgmma_bwd_refuses_other_shapes(n, d, want):
    """Shapes K2b wgmma does not take keep the variants they had: D not a
    multiple of 128 (its 128-column halves of D whole), on mma.sync where
    D % 16 == 0."""
    assert not k2.wgmma_bwd_takes(n, d)
    assert k2.attention_bwd_variant(n, d, BF16, True) == want


def test_wgmma_bwd_layout_mirrors_the_kernels_plan():
    """wgmma_bwd_layout and wgmma_bwd_takes against the constants and the
    static_assert of csrc/attention_bwd_wgmma.cuh."""
    import re
    src = (_build.CSRC / "attention_bwd_wgmma.cuh").read_text()
    for text in ("constexpr int kMaxStages = 16;",
                 "constexpr int kStatsBytes = 512 * 16;",
                 "constexpr int kMaxFusedN = 128;",
                 "constexpr int kBarrierBytes = 512;",
                 "constexpr int kStageRow = 64 * 2 + 16;",
                 "stages = stages > 4 ? 4 : stages;",
                 "const int sps = slabs == 2 ? 2 : 1;",
                 "const int split = 4 * ks * 128 * 128;"):
        assert text in src, text
    assert k2.WGB_MAX_STAGES == 16 and k2.WGB_STATS_BYTES == 512 * 16
    assert k2.WGB_FIXED == 1024 + 8 * 16 * 144 + 512
    block = src[src.index("static_assert(takes("):]
    block = block[:block.index(");")]
    checks = re.findall(r"layout\((\d+), (\d+)\)\.(\w+) (==|>=) ([\d *]+)",
                        block)
    assert len(checks) >= 9
    for n, d, field, op, value in checks:
        got, want = k2.wgmma_bwd_layout(int(n), int(d))[field], eval(value)
        assert (got == want) if op == "==" else (got >= want), (n, d, field)
    blocked = re.findall(r"(!?)layout\((\d+), (\d+)\)\.blocked", block)
    assert len(blocked) == 3
    for neg, n, d in blocked:
        assert k2.wgmma_bwd_layout(int(n), int(d))["blocked"] == (neg != "!")
    takes = re.findall(r"(!?)takes\((\d+), (\d+)\)", block)
    assert len(takes) == 9
    for neg, n, d in takes:
        assert k2.wgmma_bwd_takes(int(n), int(d)) == (neg != "!"), (n, d)
    # the fused design's halves of D over blocks at a small B: units (a
    # batch index each at N > 64) x hsplit within the 132 SMs
    splits = re.findall(r"fused_hsplit\((\d+), (\d+), (\d+)\) == (\d+)",
                        src)
    assert len(splits) == 4
    for units, halves, sms, want in splits:
        d = 128 * int(halves)
        assert k2.wgmma_bwd_hsplit(int(units), 128, d, int(sms)) == \
            int(want), (units, halves)
    assert [k2.wgmma_bwd_hsplit(b, n, d) for b, n, d in (
        (32, 128, 512), (64, 128, 256), (512, 128, 256), (512, 512, 128))] \
        == [4, 2, 1, 1]


def _fma32(a, b, c):
    """fmaf(a, b, c): a b + c in float32 with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _k2b_wgmma_emulated(q, k, v, g, scale):
    """K2b wgmma's order of sums (csrc/attention_bwd_wgmma.cu), in the
    design ``wgmma_bwd_layout`` names: q k^T and g v^T from bf16 products
    in 16-wide chunks of D, slab by slab; fused (N <= 128): the exact
    softmax of each row over all its keys; two-pass: each row's max m, sum
    l and D's sum of e dp kept over key tiles (128 keys at D = 128, else
    64), both sums rescaled by exp(m - m_new) (fmaf) when the max grows,
    D = that sum / l, and p recomputed as exp(s - m) / l from them (the
    dk/dv kernel's p^T too); ds = p (dp - D); then dq = ds k over 16-key
    chunks in key order, dv = p^T g and dk = ds^T q over 16-query chunks,
    each chunk's hi then lo product into one float32 accumulator; each
    output rounded once."""
    n, d = q.shape[-2:]
    lay = k2.wgmma_bwd_layout(n, d)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = _mma_sum((qf,), kf.transpose(-1, -2)) * scale
    dp = _mma_sum((gf,), vf.transpose(-1, -2))
    if lay["blocked"]:
        return _k2b_blocked_emulated(qf, kf, gf, s, dp, scale)
    if lay["fused"]:
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l_ = e.sum(-1, keepdim=True)
        p = e / l_
        dd = (dp * p).sum(-1, keepdim=True)
    else:
        tile = 128 if lay["sps"] == 2 else 64
        m = torch.full(s.shape[:-1] + (1,), -float("inf"))
        l_ = torch.zeros_like(m)
        es = torch.zeros_like(m)
        for j0 in range(0, n, tile):
            st, dt = s[..., j0:j0 + tile], dp[..., j0:j0 + tile]
            tm = torch.maximum(m, st.amax(-1, keepdim=True))
            e = torch.exp(st - tm)
            f = torch.exp(m - tm)
            l_ = _fma32(l_, f, e.sum(-1, keepdim=True))
            es = _fma32(es, f, (e * dt).sum(-1, keepdim=True))
            m = tm
        dd = es / l_
        p = torch.exp(s - m) / l_
    ds = p * (dp - dd)
    dq = _mma_sum(_split(ds), kf) * scale
    dv = _mma_sum(_split(p.transpose(-1, -2)), gf)
    dk = _mma_sum(_split(ds.transpose(-1, -2)), qf) * scale
    return tuple(t.to(BF16) for t in (dq, dk, dv))


def _k2b_blocked_emulated(qf, kf, gf, s, dp, scale):
    """The blocked design's order (N > 128 with D > 256): each 128-key
    block's row max, sum of e and sum of e dp (e = exp(s - block max));
    those combined in block order (fmaf, rescaled to the row's max); p and
    ds from them; each 128 x 128 block's dq, dv, dk partial over 16-wide
    chunks of its keys or queries (hi then lo), summed over the blocks in
    order in float32, then times scale (dq, dk) and rounded once."""
    n = s.shape[-1]
    blocks = [(j0, min(n, j0 + 128)) for j0 in range(0, n, 128)]
    parts = []
    for j0, j1 in blocks:
        sj, dj = s[..., j0:j1], dp[..., j0:j1]
        mj = sj.amax(-1, keepdim=True)
        e = torch.exp(sj - mj)
        parts.append((mj, e.sum(-1, keepdim=True),
                      (e * dj).sum(-1, keepdim=True)))
    m = torch.stack([pt[0] for pt in parts]).amax(0)
    l_ = torch.zeros_like(m)
    es = torch.zeros_like(m)
    for mj, lj, ej in parts:
        f = torch.exp(mj - m)
        l_ = _fma32(lj, f, l_)
        es = _fma32(ej, f, es)
    dd = es / l_
    p = torch.exp(s - m) / l_
    ds = p * (dp - dd)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(gf)
    for j0, j1 in blocks:      # dq: key blocks in order
        dq = dq + _mma_sum(_split(ds[..., j0:j1]), kf[..., j0:j1, :])
    for i0, i1 in blocks:      # dk, dv: query blocks in order
        pt = p[..., i0:i1, :].transpose(-1, -2)
        dst = ds[..., i0:i1, :].transpose(-1, -2)
        dv = dv + _mma_sum(_split(pt), gf[..., i0:i1, :])
        dk = dk + _mma_sum(_split(dst), qf[..., i0:i1, :])
    return tuple(t.to(BF16) for t in (dq * scale, dk * scale, dv))


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("n,d", [(128, 256), (32, 512), (512, 128),
                                 (128, 512), (256, 256), (512, 512)])
def test_wgmma_bwd_order_mirror_keeps_the_gate(n, d, peaked):
    """The mirror of K2b wgmma's order of sums (the fused pass at N <= 128,
    the two passes with their rescaled statistics over key tiles at N >
    128, the blocks' partials at the edge N = D = 512, the split pairs) at
    each path's (N, D) and the edge passes chip_smoke.py's
    bf16 gate (``require_k2``: 2 spacings at max |ref|, at most 1 % of
    outputs not bit-equal) against the plain version and against the JAX
    rule ``_bwd``, closer than the gate needs: at most 1 spacing, 0.5 % of
    outputs not bit-equal."""
    (q, k, v, g), plain, jax_out = _emulation(n, d, peaked)
    assert k2.wgmma_bwd_layout(n, d)["fused"] == (n <= 128 or d > 256)
    assert k2.wgmma_bwd_layout(n, d)["blocked"] == (n > 128 and d > 256)
    got = _k2b_wgmma_emulated(q, k, v, g, 1.0 / d)
    for name, out, ref, jref in zip(("dq", "dk", "dv"), got, plain, jax_out):
        for what, want in (("plain", ref), ("jax", jref)):
            _, spacings, share = cs.require_k2(out, want,
                                               f"wgmma {name} {what}")
            assert spacings <= 1.0 and share <= 5e-3, (name, what, spacings,
                                                        share)

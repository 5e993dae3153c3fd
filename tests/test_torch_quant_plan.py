"""K3's host-side plan and the folded dequantize scale, on the CPU.

``ops/quant_kernel.py::k3_plan`` decides, before any launch, which K3
variant a convolution takes and how the ``wgmma`` variant cuts it: the
TMA box of x (a 128-pixel M tile of whole image rows), the output
channels a tile (BN, by the stated rule ``conv_bn``) and the persistent
grid.  The kernel (``csrc/quant_conv_wgmma.cu``) walks units ``u`` in
``[0, units)``, decodes each into (M tile, N tile) with the output-
channel tile fastest, and loads each of the unit's k chunks ``c`` at tap
``c // ci_chunks``.  These tests replay that walk for every main-path
shape and the edge shapes and check that every output pixel, output
channel and k chunk is covered exactly once; that each unit runs all its
k chunks; that the shape rule sends every main-path shape to ``wgmma``
with the plans it has always had; and that the
scale formed in the kernel from ``x_scale`` and ``w_scale`` apart gives
the plain version's output bit for bit.  The kernels themselves run only
on the card: ``chip_smoke.py`` holds them against the plain version.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import quant as tq
from tera_mind_tpu_torch.ops import quant_kernel as qk

SHAPES = cs.K3_SHAPES + cs.K3_EDGE
IDS = ["x".join(map(str, x)) + "-" + "x".join(map(str, w))
       for x, w in SHAPES]
WGMMA_CU = (_build.CSRC / "quant_conv_wgmma.cu").read_text()


def _decode(u, n_tiles):
    """The kernel's tile_of: output-channel tiles fastest, then M
    tiles."""
    mt = u // n_tiles
    return mt, u - mt * n_tiles


@pytest.mark.parametrize("x_shape,w_shape", SHAPES, ids=IDS)
def test_plan_covers_every_pixel_channel_and_chunk_once(x_shape, w_shape):
    b, h, w, ci = x_shape
    co, kh, kw = w_shape
    p = qk.k3_plan(x_shape, w_shape)
    m_total = b * h * w
    if p.variant == "mma_sync":
        # one block a 128 x 128 tile, every tile once
        assert p.bn == 128
        assert (p.m_tiles, p.n_tiles) == (-(-m_total // 128), -(-co // 128))
        assert p.grid == p.units == p.m_tiles * p.n_tiles
        return
    bw, bh, bb = p.box
    cip = qk.round_up(ci, qk.conv_align(ci))
    ci_chunks = -(-cip // qk.K3_BK)
    assert p.k_chunks == kh * kw * ci_chunks
    assert p.m_tiles == -(-m_total // qk.K3_BM)
    assert p.n_tiles == -(-co // p.bn)
    assert p.units == p.m_tiles * p.n_tiles
    assert 1 <= p.grid <= min(p.units, qk.H100_SMS)
    # the box: whole image rows, 128 pixels, within TMA's 256 a dim
    assert bw == w and bw * bh * bb == qk.K3_BM and max(p.box) <= 256
    # every M tile's box starts on an image row the box tiles: its
    # pixel rho is output pixel m0 + rho, so rows past m_total are past
    # the last image (zero-filled) and no pixel is loaded twice
    mt = np.arange(p.m_tiles, dtype=np.int64)
    m0 = mt * qk.K3_BM
    b0, h0 = m0 // (h * w), (m0 % (h * w)) // w
    assert np.all(m0 % (h * w) % w == 0)
    assert np.all(h0 % bh == 0) and (bb == 1 or np.all(h0 == 0))
    rho = np.arange(qk.K3_BM)
    ib, ih, iw = rho // (bh * bw), rho // bw % bh, rho % bw
    pix = ((b0[:, None] + ib) * h + h0[:, None] + ih) * w + iw
    assert np.array_equal(pix, m0[:, None] + rho)
    # units: each (M tile, N tile, k chunk) exactly once
    seen = np.zeros((p.m_tiles, p.n_tiles, p.k_chunks), np.int32)
    for u in range(p.units):
        m, n = _decode(u, p.n_tiles)
        seen[m, n, :] += 1
    assert np.all(seen == 1)
    # and each chunk is one tap's 128 channels of Ci_pad, every channel
    # of every tap once
    c = np.arange(p.k_chunks)
    tap, cc = c // ci_chunks, c % ci_chunks
    assert sorted(zip(tap.tolist(), cc.tolist())) == [
        (t, k) for t in range(kh * kw) for k in range(ci_chunks)]
    assert ci_chunks * qk.K3_BK >= cip > (ci_chunks - 1) * qk.K3_BK


@pytest.mark.parametrize("x_shape,w_shape", SHAPES, ids=IDS)
def test_each_unit_runs_all_its_chunks_at_the_stated_bn(x_shape, w_shape):
    p = qk.k3_plan(x_shape, w_shape)
    # one unit a tile: K is not split, so every unit runs all k chunks
    # and writes its tile once
    assert p.units == p.m_tiles * p.n_tiles
    assert p.grid == min(p.units, qk.H100_SMS)
    # the ring the plan counts is the kernel's (Cfg<BN>::kStages)
    if p.variant == "wgmma":
        assert p.bn == qk.conv_bn(w_shape[0])
        assert p.stages == {256: 4, 128: 6}[p.bn]
        assert p.stages * (qk.K3_BM + p.bn) * qk.K3_BK <= qk.K3_RING_BYTES


def test_every_main_path_shape_takes_wgmma():
    plans = [qk.k3_plan(x, w) for x, w in cs.K3_SHAPES]
    assert {p.variant for p in plans} == {"wgmma"}
    # the plans the main path has been timed with: BN 256 where Co > 128,
    # else 128; a round of 132 SMs, but for the 8 x 8 level's 82 tiles
    # of (81, 8, 8, 512) and 128 tiles at B = 64
    assert [p.bn for p in plans] == [
        256 if w[0] > 128 else 128 for _, w in cs.K3_SHAPES]
    assert [p.grid for p in plans] == [132] * 33 + [82] + [132] * 5 + [
        128] * 5
    edge = {x: qk.k3_plan(x, w) for x, w in cs.K3_EDGE}
    assert {x: p.variant for x, p in edge.items()} == {
        (2, 8, 8, 970): "wgmma", (1, 8, 8, 18): "wgmma",
        (3, 5, 7, 40): "mma_sync"}


@pytest.mark.parametrize("ci,pad", [
    (18, 32), (128, 128), (192, 192), (320, 320), (448, 448), (229, 240),
    (970, 1024), (1024, 1024), (1482, 1536), (1994, 2048), (2506, 2560)])
def test_conv_channels_pad_to_128_only_where_it_is_cheap(ci, pad):
    """The deep concats pad to 128 (at most 1/16 more bytes), so their
    rows start on 128-byte lines; narrower ragged rows keep 16."""
    assert qk.round_up(ci, qk.conv_align(ci)) == pad
    assert qk.round_up(ci, qk.conv_align(ci)) - ci <= max(ci / 16, 15)


@pytest.mark.parametrize("h,w,box", [
    (64, 64, (64, 2, 1)), (32, 32, (32, 4, 1)), (16, 16, (16, 8, 1)),
    (8, 8, (8, 8, 2)), (4, 4, (4, 4, 8)), (1, 128, (128, 1, 1)),
    (5, 7, None), (8, 12, None), (6, 8, None), (256, 256, None)])
def test_wgmma_box_rule(h, w, box):
    assert qk.wgmma_box(h, w) == box
    assert qk.conv_variant(h, w) == ("mma_sync" if box is None
                                     else "wgmma")


def test_plan_forces_a_variant_and_refuses_wgmma_off_the_rule():
    x, w = (81, 8, 8, 970), (1024, 3, 3)
    assert qk.k3_plan(x, w, variant="mma_sync").variant == "mma_sync"
    assert qk.k3_plan(x, w).variant == "wgmma"
    with pytest.raises(ValueError, match="wgmma takes no 5x7"):
        qk.k3_plan((3, 5, 7, 40), (16, 3, 3), variant="wgmma")
    with pytest.raises(ValueError, match="no variant"):
        qk.k3_plan(x, w, variant="dequant")
    # fewer SMs: more rounds, the same coverage rules
    small = qk.k3_plan(x, w, sms=16)
    assert small.grid == 16 and small.units == qk.k3_plan(x, w).units


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [True, False])
def test_folded_scale_is_bit_equal_to_the_product(out_dtype, bias):
    """x_scale and w_scale passed apart give what the product passed as
    one scale gave (``f32(acc) * (s_x * s_w) + bias``), bit for bit: the
    kernel's __fmul_rn(s_x, s_w[co]) is that one float32 product."""
    rng = np.random.default_rng(14)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 8, 8, 48),
                                       dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (24, 3, 3, 48),
                                       dtype=np.int8))
    sw = torch.from_numpy(rng.random(24, dtype=np.float32) * 1e-3 + 1e-6)
    sx = torch.tensor(np.float32(rng.random() * 1e-2 + 1e-5))
    b = torch.from_numpy(rng.standard_normal(24, dtype=np.float32))
    b = b if bias else None
    got = qk.quant_conv_plain(xq, wq, sw, b, out_dtype, x_scale=sx)
    acc = qk.quant_conv_plain(xq, wq, out_dtype=torch.int32)
    want = acc.float() * (sx * sw)
    want = (want + b if bias else want).to(out_dtype)
    assert torch.equal(got, want)
    assert torch.equal(qk.quant_conv(xq, wq, sw, b, out_dtype, x_scale=sx),
                       want)
    # no x_scale: s_x = 1, whose product leaves s_w as it is
    assert torch.equal(qk.quant_conv_plain(xq, wq, sw * sx, b, out_dtype),
                       want)


def test_quant_conv2d_passes_the_scales_apart(monkeypatch):
    """quant_conv2d hands K3 the weight scales and the activation scale
    apart (the kernel forms their product), and its output equals the
    product formed outside."""
    seen = {}
    plain = qk.quant_conv

    def spy(xq, wq, w_scale=None, bias=None, out_dtype=torch.bfloat16,
            x_scale=None):
        seen.update(w_scale=w_scale, x_scale=x_scale)
        return plain(xq, wq, w_scale, bias, out_dtype, x_scale)

    monkeypatch.setattr(qk, "quant_conv", spy)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 20),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 20, 3, 3),
                                             dtype=np.float32))
    y = tq.quant_conv2d(x, w, None, ((1, 1), (1, 1)), torch.float32)
    xq, sx = tq.quantize_tensor(x)
    wq, sw = tq.quantize_weight(w)
    assert seen["x_scale"].shape == () and seen["w_scale"].shape == (16,)
    assert torch.equal(seen["x_scale"], sx)
    assert torch.equal(seen["w_scale"], sw)
    acc = qk.quant_conv_plain(qk.pad_last(xq, 16),
                              qk.pad_last(wq.permute(0, 2, 3, 1), 16),
                              out_dtype=torch.int32)
    assert torch.equal(y, acc.float() * (sx * sw))


def test_kernel_sources_match_the_plan_constants():
    """The wgmma kernel's tile, chunk and ring sizes are the plan's, and
    it forms the scale and dequantizes with the plain version's
    roundings."""
    assert f"constexpr int kBM = {qk.K3_BM};" in WGMMA_CU
    assert f"constexpr int kBK = {qk.K3_BK};" in WGMMA_CU
    assert (f"constexpr int kRingBytes = {qk.K3_RING_BYTES // 1024} * 1024;"
            in WGMMA_CU)
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in WGMMA_CU
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in WGMMA_CU
    # the TMA loads and tensor maps live in csrc/hopper.cuh, which the
    # kernel includes (shared with K2's wgmma variant)
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in WGMMA_CU
    assert "tma_load_4d(st, &xmap" in WGMMA_CU
    assert "cp.async.bulk.tensor.4d" in hopper
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in hopper
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in WGMMA_CU
    assert "s0 = __fmul_rn(sxv, sw[n]);" in WGMMA_CU
    assert "return __fadd_rn(__fmul_rn(__int2float_rn(v), s), b);" in \
        WGMMA_CU
    # the tile schedule the tests above replay
    assert "return Tile{mt, u - mt * a.n_tiles};" in WGMMA_CU
    quant = (_build.CSRC / "quantize.cu").read_text()
    assert (f"constexpr int kBlocksPerSM = {qk.K4_BLOCKS_PER_SM};"
            in quant)
    assert "cudaLaunchCooperativeKernel" in quant
    assert "cudaMemsetAsync" not in quant

"""K6, the packed ResBlock's residual sum with its convs' biases, on the CPU.

``ops/residual_kernel.py``: its plain version against the eager sequence
it replaces (a conv's broadcast bias add after the convolution, then
``(x + h).to(dt)``), bit for bit in bf16 and float32, with a skip conv,
with the block's input and after ``_up2`` / ``_down2``; the dispatcher's
routing (the plain sequence on the CPU and under autograd, no launch);
the wrapper's checks, variant rule and grid as pure functions; the
refusals; the Python mirrors of ``csrc/residual.cu``'s constants.  The
kernel itself runs only on the card (``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch

from tera_mind_tpu_torch.models import unet_packed as tpk
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import residual_kernel as k6

DTYPES = [torch.float32, torch.bfloat16]


def draw(seed, *shape, dtype=torch.float32, scale=1.0):
    """A seeded numpy normal draw as a tensor of ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def eager_conv_bias(y, bias):
    """PyTorch's cuDNN route: the convolution's NCHW view of a
    channels-last output, then ``output.add_(bias.reshape(1, C, 1, 1))``
    in place."""
    out = y.clone()
    out.permute(0, 3, 1, 2).add_(bias.reshape(1, -1, 1, 1))
    return out


def eager_block_end(h, h_bias, x, s_bias=None):
    """The ResBlock's eager end: out_conv's bias add, the skip conv's (or
    the block's x), then ``(x + h).to(dt)``."""
    h = eager_conv_bias(h, h_bias)
    if s_bias is not None:
        x = eager_conv_bias(x, s_bias)
    return (x + h).to(h.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("skip", ["conv", "x", "up", "down"])
def test_plain_is_the_eager_sequence(dtype, skip):
    """residual_plain gives the eager sequence's bits: with a skip conv's
    product and bias, with the block's x, and with x after the packed
    upsample or average pool (a width that is not a multiple of 8, a
    few planes)."""
    b, hw, width = 3, 8, 2 * 13
    h = draw(1, b, hw, hw, width, dtype=dtype, scale=3.0)
    hb = draw(2, width, dtype=dtype, scale=0.5)
    sb = draw(3, width, dtype=dtype, scale=0.5) if skip == "conv" else None
    if skip == "up":
        s = tpk._up2(draw(4, b, hw // 2, hw // 2, width, dtype=dtype))
    elif skip == "down":
        s = tpk._down2(draw(4, b, 2 * hw, 2 * hw, width, dtype=dtype))
    else:
        s = draw(4, b, hw, hw, width, dtype=dtype, scale=3.0)
    got = k6.residual_plain(h, hb, s, sb)
    want = eager_block_end(h, hb, s, sb)
    assert got.dtype == dtype and got.shape == h.shape
    assert torch.equal(got, want)
    # the dispatcher takes the plain version for a CPU tensor, no launch
    k6.reset_launches()
    assert torch.equal(k6.residual(h, hb, s, sb), want)
    assert k6.launches == 0


def test_bf16_rounds_each_add_where_the_eager_sequence_does():
    """In bf16 each add rounds: the sum of the rounded terms, not the
    float32 sum rounded once, so the two bias adds and the residual are
    three roundings (sums that differ at the 2^-8 scale)."""
    one = torch.tensor([[1.0]], dtype=torch.bfloat16)
    tiny = torch.tensor([2.0 ** -8], dtype=torch.bfloat16)
    # h + b_h = 1 + 2^-8 rounds to 1 (to even), and so does 2^-8 + 1;
    # the float32 sum 1 + 2^-8 + 2^-8 = 1 + 2^-7 would be a bf16 value
    out = k6.residual_plain(one, tiny, one * 0, tiny)
    assert float(out) == 1.0
    assert float(k6.residual_plain(one, tiny, one, None)) == 2.0


def test_dispatcher_records_the_plain_sequence_under_autograd():
    """Where autograd records, the dispatcher runs the plain sequence
    (no launch), whose gradient flows to h, s and both biases."""
    h = draw(5, 4, 24).requires_grad_(True)
    hb = draw(6, 24).requires_grad_(True)
    s = draw(7, 4, 24).requires_grad_(True)
    sb = draw(8, 24).requires_grad_(True)
    k6.reset_launches()
    out = k6.residual(h, hb, s, sb)
    out.sum().backward()
    assert k6.launches == 0 and out.grad_fn is not None
    assert torch.equal(h.grad, torch.ones_like(h))
    assert torch.equal(hb.grad, torch.full_like(hb, 4.0))
    assert torch.equal(sb.grad, torch.full_like(sb, 4.0))
    with torch.no_grad():
        assert k6.residual(h, hb, s, sb).grad_fn is None


@pytest.mark.parametrize("what,args,err", [
    ("s of another shape", ((4, 24), (24,), (4, 16), None), ValueError),
    ("h bias of another width", ((4, 24), (16,), (4, 24), None),
     ValueError),
    ("s bias of another width", ((4, 24), (24,), (4, 24), (8,)),
     ValueError),
    ("a 2D bias", ((4, 24), (1, 24), (4, 24), None), ValueError)])
def test_refusals_before_any_launch(what, args, err):
    h, hb, s, sb = (None if a is None else torch.zeros(a) for a in args)
    for fn in (k6.residual, k6.residual_plain):
        with pytest.raises(err):
            fn(h, hb, s, sb)


def test_refuses_mixed_or_unsupported_dtypes_and_devices():
    h, hb, s = torch.zeros(4, 8), torch.zeros(8), torch.zeros(4, 8)
    with pytest.raises(ValueError):
        k6.residual(h, hb.bfloat16(), s)
    with pytest.raises(ValueError):
        k6.residual(h, hb, s.bfloat16())
    with pytest.raises(TypeError):
        k6.residual(h.half(), hb.half(), s.half())
    with pytest.raises(RuntimeError, match="no path"):
        k6.residual(h.to("meta"), hb.to("meta"), s.to("meta"))


def test_raw_launcher_refuses_autograd_before_anything_else():
    """The raw CUDA launcher records no backward: an input that requires
    grad under grad mode raises before the launch (checked here on the
    CPU, where the refusal comes first)."""
    h = torch.zeros(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        k6.residual_cuda(h, torch.zeros(8), torch.zeros(4, 8))


@pytest.mark.parametrize("width,itemsize,aligned,want", [
    (128, 2, True, "vector"), (1024, 2, True, "vector"),
    (520, 2, True, "vector"), (100, 2, True, "scalar"),
    (128, 2, False, "scalar"), (100, 4, True, "vector"),
    (98, 4, True, "scalar"), (64, 4, False, "scalar")])
def test_variant_rule(width, itemsize, aligned, want):
    assert k6.residual_variant(width, itemsize, aligned) == want


def test_every_path_width_takes_vector():
    """Every (rows, width, skip) the 638850 block-major chain gives K6 is
    a whole number of 16-byte vectors a row: the vector variant."""
    import chip_smoke as cs
    shapes = cs.k6_shapes()
    assert len(shapes) == 17 and {s[2] for s in shapes} == {"conv", "x"}
    assert all(k6.residual_variant(w, 2, True) == "vector"
               for _, w, _ in shapes)


@pytest.mark.parametrize("rows,width,itemsize,variant", [
    (331776, 128, 2, "vector"), (5184, 1024, 2, "vector"),
    (7, 100, 2, "scalar"), (1, 4096, 2, "vector"), (129, 100, 4, "vector"),
    (3, 12288, 4, "scalar")])
def test_grid_keeps_each_thread_on_one_column(rows, width, itemsize,
                                              variant):
    """The launch's grid (``launch`` in csrc/residual.cu): at most 4
    blocks an SM of 256 threads, a stride that is a whole number of rows,
    so each thread's column (and its bias) stays fixed; every unit of
    the map is visited once by the grid-stride walk."""
    sms = 132
    blocks, stride = k6.grid(rows, width, itemsize, variant, sms)
    w = width // (16 // itemsize) if variant == "vector" else width
    n = rows * w
    assert 1 <= blocks <= k6.BLOCKS_PER_SM * sms
    assert stride > 0 and stride % w == 0 and stride <= blocks * k6.THREADS
    seen = np.zeros(n, np.int64)
    for t in range(min(stride, n)):
        seen[t::stride] += 1
    assert (seen == 1).all()
    # a thread's units all lie in its column
    t = stride - 1
    assert {i % w for i in range(t, n, stride)} <= {t % w}


def test_wrapper_mirrors_the_source():
    """The constants the wrapper mirrors are ``csrc/residual.cu``'s, the
    C entry point's arguments are the ctypes signature's, and the build
    compiles the file into the one library."""
    src = (_build.CSRC / "residual.cu").read_text()
    for line in (f"constexpr int kThreads = {k6.THREADS};",
                 f"constexpr int kBlocksPerSm = {k6.BLOCKS_PER_SM};",
                 f"constexpr int kUnroll = {k6.UNROLL};",
                 "enum : int { kScalar = 0, kVector = 1 };",
                 "__launch_bounds__(kThreads, kBlocksPerSm)",
                 "const long long stride = blocks * kThreads / w * w;"):
        assert line in src, line
    assert k6.VARIANTS == ("scalar", "vector")
    assert k6.SKIPS == ("x", "conv")
    args = re.search(r'extern "C" int tmt_residual\(([^)]*)\)', src)
    assert len(args.group(1).split(",")) == len(
        _build.SIGNATURES["tmt_residual"]) == 10
    assert "__hadd2_rn" in src and "__fadd_rn" in src
    assert "unet_packed.py:132-133" in src and ":299" in src
    assert "residual.cu" in {p.name for p in _build.sources()}

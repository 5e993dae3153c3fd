"""The DiT block's fold on the CPU: K1's modulate epilogue and K7.

``ops/rmsnorm_kernel.rmsnorm_modulate`` (the adaLN modulate after the
block's norms) and ``ops/gated_residual_kernel.gated_residual`` (its
``xt + gate * y``): their plain versions against the eager sequences they
replace, bit for bit in bf16 and float32, with scale, shift and gate as
the strided chunks of a (B, N, 7C) adaLN output; a numpy emulation of the
kernels' rounding rule against the plain versions; the ``DiTBlock``
through the dispatchers against JAX's ``DiTBlock`` (both token orders and
int8); the routing (the CPU and autograd take the plain versions, no
launch; the CUDA launchers' checks refuse before the library is loaded);
the variant rules, K7's grid and the sources' constants; the launches
``scripts/kernel_shapes.py`` and ``chip_smoke.py`` predict on every path.
The kernels themselves run only on the card (``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch
from test_torch_models import close, randn, seeded_params, t

from tera_mind_tpu.models import attention as jattn
from tera_mind_tpu_torch.convert import load_jax_params
from tera_mind_tpu_torch.models import attention as tattn
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import gated_residual_kernel as k7
from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: tier-1 runs several pytest workers on one host,
    whose full thread pools oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ks():
    """``scripts/kernel_shapes.py`` as ``chip_smoke.py`` loads it."""
    import chip_smoke as cs
    return cs.kernel_shapes()


def draw(seed, *shape, dtype=torch.float32, scale=1.0):
    """A seeded numpy normal draw as a tensor of ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def dit_operands(dtype, b=2, n=24, c=16, seed=0):
    """(x, the adaLN output (B, N, 7C), y, the norm's weight) and the
    chunks the DiT block takes of the adaLN output: (shift, scale,
    gate), strided views (7C elements a row)."""
    x = draw(seed, b, n, c, dtype=dtype, scale=2.0)
    ada = draw(seed + 1, b, n, 7 * c, dtype=dtype, scale=0.5)
    y = draw(seed + 2, b, n, c, dtype=dtype, scale=2.0)
    w = (1 + 0.1 * draw(seed + 3, c)).to(dtype)
    shift, scale, gate = ada.chunk(7, -1)[:3]
    return x, ada, y, w, shift, scale, gate


# --------------------------------------------------------------------- #
# plain versions against the eager sequences                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_the_eager_sequences(dtype):
    """The plain versions give the DiT block's former eager bits, on the
    strided chunks: ``norm(x) * (scale + 1.0) + shift`` with the block's
    RMSNorm module, and ``xt + gate * y``; the dispatchers take them on
    the CPU with no launch."""
    x, _, y, w, shift, scale, gate = dit_operands(dtype)
    assert scale.stride() == (24 * 7 * 16, 7 * 16, 1)
    norm = tattn.RMSNorm(16)
    with torch.no_grad():
        norm.weight.copy_(w.float())
    eager_mod = norm(x) * (scale + 1.0) + shift
    eager_gated = x + gate * y
    got = k1.rmsnorm_modulate_plain(x, norm.weight, scale, shift)
    assert got.dtype == dtype and torch.equal(got, eager_mod)
    assert torch.equal(k7.gated_residual_plain(x, gate, y), eager_gated)
    k1.reset_launches()
    k7.reset_launches()
    with torch.no_grad():
        assert torch.equal(k1.rmsnorm_modulate(x, norm.weight, scale, shift),
                           eager_mod)
        assert torch.equal(k7.gated_residual(x, gate, y), eager_gated)
    assert k1.launches == k7.launches == 0
    assert k1.launches_by_epilogue == {"none": 0, "modulate": 0}


def bf16(a):
    """float32 numpy values rounded to bf16 (round to nearest even), as
    float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16() \
        .float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_rounding_rule_is_the_plain_versions(dtype):
    """The kernels' arithmetic emulated in numpy: the modulate of
    csrc/common.cuh on K1's rounded y, r(r(y * r(1 + s)) + sh), and K7's
    r(x + r(g * y)), each product and sum a float32 op rounded to the
    dtype (no fused multiply-add), give the plain versions' bits."""
    x, _, y, w, shift, scale, gate = dit_operands(dtype, seed=5)
    r = bf16 if dtype == torch.bfloat16 else (lambda a: np.float32(a))
    f = [a.float().numpy() for a in (x, y, shift, scale, gate)]
    xf, yf, hf, sf, gf = f
    norm = k1.rmsnorm_plain(x, w).float().numpy()
    mod = r(r(norm * r(np.float32(1) + sf)) + hf)
    want = k1.rmsnorm_modulate_plain(x, w, scale, shift).float().numpy()
    np.testing.assert_array_equal(mod, want)
    gated = r(xf + r(gf * yf))
    np.testing.assert_array_equal(
        gated, k7.gated_residual_plain(x, gate, y).float().numpy())


def test_bf16_rounds_each_step_where_the_eager_ops_do():
    """In bf16 each op rounds: the product and the sum are two
    roundings, not one (a fused multiply-add gives another bit), which is
    why the kernels use the _rn forms."""
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    x = torch.tensor([1.0], dtype=torch.bfloat16)
    g = torch.tensor([1.0 + 2.0 ** -7], dtype=torch.bfloat16)
    y = torch.tensor([2.0 ** -8 * (1.0 - 2.0 ** -8)], dtype=torch.bfloat16)
    # g * y = 2^-8 (1 + 2^-8 - 2^-15) rounds down to 2^-8, and 1 + 2^-8
    # is a tie that rounds to 1 (to even); rounded once, 1 + g * y lies
    # past the tie and rounds up to 1 + 2^-7
    got = k7.gated_residual_plain(x, g, y)
    once = (x.float() + g.float() * y.float()).bfloat16()
    assert float(got) == 1.0 and float(once) != float(got)
    assert float(k1.modulate_plain(one, one * 0, one * 0)) == 1.0


# --------------------------------------------------------------------- #
# the DiT block through the dispatchers against JAX                      #
# --------------------------------------------------------------------- #
# The inputs are the existing DiT parity tests' (tests/test_torch_models.py
# and tests/test_torch_packed.py); at float32 int8 matches JAX where no
# quantized activation lies within a float rounding of an int8 tie (the
# int8 model tests bound such flips separately).
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_dit_block_through_the_dispatchers_matches_jax(packed, quant):
    """``DiTBlock.forward`` (norm1 / norm2 through ``rmsnorm_modulate``,
    both sub-layers ending in ``gated_residual``) against JAX's DiTBlock,
    5D and packed tokens, float and int8, within the DiT parity tests'
    float32 tolerance; no kernel launch on the CPU."""
    data, params = (8, 9) if packed else (13, 14)
    rng = np.random.default_rng(data)
    if packed:
        x, cond = randn(rng, 2, 8, 8, 2 * 16), randn(rng, 2, 8, 8, 2 * 6)
        args = (x, cond, 2)
    else:
        x, cond = randn(rng, 2, 2, 8, 8, 16), randn(rng, 2, 2, 8, 8, 6)
        args = (x, cond)
    jm = jattn.DiTBlock(hidden_size=16, n_win=2, quant=quant,
                        packed_tokens=packed)
    p = seeded_params(jm, *args, seed=params)
    tm = load_jax_params(tattn.DiTBlock(16, 6, n_win=2, quant=quant,
                                        packed_tokens=packed), p)
    k1.reset_launches()
    k7.reset_launches()
    with torch.no_grad():
        got = tm(t(x), t(cond), *args[2:])
    close(got, jm.apply(p, *args))
    assert k1.launches == k7.launches == 0


def test_dit_block_records_the_eager_sequence_under_autograd():
    """Where autograd records, the block runs K1's Function (plain on the
    CPU) and the eager modulate and gated residual: the same values as
    under no_grad, and a gradient for every parameter."""
    rng = np.random.default_rng(3)
    x, cond = t(randn(rng, 2, 2, 8, 8, 16)), t(randn(rng, 2, 2, 8, 8, 6))
    blk = tattn.DiTBlock(16, 6, n_win=2)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for q in blk.parameters():
            q.copy_(0.3 * torch.randn(q.shape, generator=g))
        want = blk(x, cond)
    out = blk(x, cond)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)
    out.square().sum().backward()
    assert all(q.grad is not None and torch.isfinite(q.grad).all()
               for q in blk.parameters())
    assert float(blk.norm1.weight.grad.abs().sum()) > 0


# --------------------------------------------------------------------- #
# routing and refusals                                                   #
# --------------------------------------------------------------------- #
def test_dispatchers_take_the_plain_versions_under_autograd():
    """Under autograd the dispatchers record the eager sequence: gradients
    reach x, the weight, scale, shift, gate and y, no launch."""
    x, ada, y, w, *_ = dit_operands(torch.float32, seed=7)
    x, ada, y, w = (a.requires_grad_(True) for a in (x, ada, y, w))
    shift, scale, gate = ada.chunk(7, -1)[:3]
    k1.reset_launches()
    k7.reset_launches()
    out = k7.gated_residual(x, gate, k1.rmsnorm_modulate(x, w, scale,
                                                         shift) * y)
    out.sum().backward()
    assert k1.launches == k7.launches == 0
    assert all(a.grad is not None for a in (x, ada, y, w))
    assert float(ada.grad[..., 3 * 16:].abs().sum()) == 0   # unused chunks
    assert float(ada.grad[..., :3 * 16].abs().sum()) > 0


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything loads the kernel library (a launch)."""
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(_build, "lib", refuse)


@pytest.mark.parametrize("what", [
    "scale of another shape", "float32 shift", "channels not contiguous",
    "rows not one stride apart", "x requires grad", "half"])
def test_rmsnorm_modulate_launcher_refuses_before_any_launch(what,
                                                             no_library):
    """The CUDA launcher's checks (run here on CPU tensors, where they
    come before the library is loaded) refuse what the kernel cannot
    take, with a message; the dispatcher refuses the same calls where no
    gradient is recorded, on the CPU too."""
    x, ada, y, w, shift, scale, gate = dit_operands(torch.bfloat16, b=8,
                                                    n=8)
    args = {
        "scale of another shape": (x, w, scale[:, :4], shift),
        "float32 shift": (x, w, scale, shift.float()),
        "channels not contiguous": (x, w, ada[..., :32:2], shift),
        "rows not one stride apart": (x, w, scale.transpose(0, 1), shift),
        "x requires grad": (x.float().requires_grad_(True), w.float(),
                            scale.float(), shift.float()),
        "half": (x.half(), w.half(), scale.half(), shift.half())}[what]
    err = RuntimeError if what == "x requires grad" else \
        TypeError if what == "half" else ValueError
    with pytest.raises(err):
        k1.rmsnorm_modulate_cuda(*args)
    if what != "x requires grad":
        with pytest.raises(err):
            k1.rmsnorm_modulate(*args)


@pytest.mark.parametrize("what", [
    "gate of another shape", "float32 y", "channels not contiguous",
    "rows not one stride apart", "x requires grad", "half", "meta"])
def test_gated_residual_launcher_refuses_before_any_launch(what,
                                                           no_library):
    x, ada, y, w, shift, scale, gate = dit_operands(torch.bfloat16, b=8,
                                                    n=8)
    args = {
        "gate of another shape": (x, gate[:, :4], y),
        "float32 y": (x, gate, y.float()),
        "channels not contiguous": (x, ada[..., :32:2], y),
        "rows not one stride apart": (x, gate.transpose(0, 1), y),
        "x requires grad": (x.float().requires_grad_(True), gate.float(),
                            y.float()),
        "half": (x.half(), gate.half(), y.half()),
        "meta": tuple(a.to("meta") for a in (x, gate, y))}[what]
    err = {"x requires grad": RuntimeError, "half": TypeError,
           "meta": RuntimeError}.get(what, ValueError)
    if what != "meta":
        with pytest.raises(err):
            k7.gated_residual_cuda(*args)
    if what != "x requires grad":
        with pytest.raises(err):
            k7.gated_residual(*args)


def test_row_view_reads_chunks_without_a_copy():
    """A chunk of a wider last axis is a (rows, C) view one stride apart:
    the kernels read it through its stride, never a copy."""
    _, ada, *_ = dit_operands(torch.float32, b=3, n=5, c=8)
    scale = ada.chunk(7, -1)[1]
    v, stride = k1.row_view(scale, 8, "scale")
    assert stride == 56 and v.data_ptr() == scale.data_ptr()
    assert v.shape == (15, 8)
    one, stride1 = k1.row_view(scale[:1, :1], 8, "scale")
    assert one.shape == (1, 8) and stride1 == 8


# --------------------------------------------------------------------- #
# variant rules, grid, source constants                                  #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("c,gstride,itemsize,aligned,want", [
    (256, 7 * 256, 2, True, "vector"), (512, 7 * 512, 2, True, "vector"),
    (128, 7 * 128, 4, True, "vector"), (100, 700, 2, True, "scalar"),
    (256, 7 * 256, 2, False, "scalar"), (64, 900, 2, True, "scalar"),
    (4, 28, 4, True, "vector"), (33, 231, 4, True, "scalar")])
def test_k7_variant_rule(c, gstride, itemsize, aligned, want):
    assert k7.gated_variant(c, gstride, itemsize, aligned) == want


@pytest.mark.parametrize("c,itemsize,aligned,mod_aligned,want", [
    (256, 2, True, True, "vector"), (512, 2, True, True, "vector"),
    (256, 2, True, False, "strided"), (256, 2, False, True, "strided"),
    (100, 2, True, True, "strided"), (2050, 2, True, True, "strided"),
    (512, 4, True, True, "vector"), (1024, 4, True, True, "strided")])
def test_k1_modulate_variant_rule(c, itemsize, aligned, mod_aligned, want):
    """K1's rule, and ``vector`` only where scale and shift start on 16
    bytes with rows a whole number of 16 bytes apart."""
    assert k1.rmsnorm_modulate_variant(c, itemsize, aligned,
                                       mod_aligned) == want
    if mod_aligned:
        assert want == k1.rmsnorm_variant(c, itemsize, aligned)


@pytest.mark.parametrize("rows,c,itemsize,variant", [
    (41472, 256, 2, "vector"), (10368, 512, 2, "vector"),
    (313344, 128, 2, "vector"), (7, 100, 2, "scalar"), (1, 4096, 2, "vector"),
    (129, 33, 4, "scalar")])
def test_k7_grid_keeps_each_thread_on_one_column(rows, c, itemsize,
                                                 variant):
    """K7's grid (``launch`` in csrc/gated_residual.cu): at most 4 blocks
    an SM of 256 threads; the threads of whole rows of units walk the map
    by ``rows a stride`` rows, each in one column, so every unit is
    visited once and the gate's unit is found as row * gstride + col."""
    sms = 132
    blocks, rstride = k7.grid(rows, c, itemsize, variant, sms)
    w = c // (16 // itemsize) if variant == "vector" else c
    assert 1 <= blocks <= k7.BLOCKS_PER_SM * sms and rstride >= 1
    assert rstride * w <= blocks * k7.THREADS
    seen = np.zeros((rows, w), np.int64)
    for tid in range(rstride * w):
        seen[tid // w::rstride, tid % w] += 1
    assert (seen == 1).all()


def test_sources_mirror_the_wrappers():
    """The constants the wrappers mirror are the sources' own, the C entry
    points' arguments are the ctypes signatures', the modulate helper is
    the one K5 and K1 share, and the build compiles K7 into the one
    library."""
    src = (_build.CSRC / "gated_residual.cu").read_text()
    for line in (f"constexpr int kThreads = {k7.THREADS};",
                 f"constexpr int kBlocksPerSm = {k7.BLOCKS_PER_SM};",
                 f"constexpr int kUnroll = {k7.UNROLL};",
                 "enum : int { kScalar = 0, kVector = 1 };",
                 "__launch_bounds__(kThreads, kBlocksPerSm)",
                 "const long long rstride = blocks * kThreads / w;"):
        assert line in src, line
    assert k7.VARIANTS == ("scalar", "vector")
    for name, src_, n in (("tmt_gated_residual", src, 10),
                          ("tmt_rmsnorm_modulate", (
                              _build.CSRC / "rmsnorm.cu").read_text(), 14)):
        args = re.search(rf'extern "C" int {name}\(([^)]*)\)', src_)
        assert len(args.group(1).split(",")) == len(
            _build.SIGNATURES[name]) == n
    assert "__hmul2_rn" in src and "__hadd2_rn" in src
    assert "__fmul_rn" in src and "__fadd_rn" in src
    assert "attention.py:196-202" in src
    assert "gated_residual.cu" in {p.name for p in _build.sources()}
    common = (_build.CSRC / "common.cuh").read_text()
    helper = ("  const float m = round_to<T>(__fadd_rn(1.0f, s));\n"
              "  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(y, m)),"
              " sh));")
    assert helper in common
    assert "float modulate(" not in (
        _build.CSRC / "grouped_rmsnorm.cuh").read_text()
    rms = (_build.CSRC / "rmsnorm.cu").read_text()
    assert rms.count("modulate<T>(round_to<T>(") == 2   # vector, wide
    assert "yw = modulate_word<T>(" in rms                # strided
    assert "nn.py:127-130" in rms
    assert k1.EPILOGUES == ("none", "modulate")


# --------------------------------------------------------------------- #
# launches on every path                                                 #
# --------------------------------------------------------------------- #
def per_call(ks, **kw):
    k1_act, k7_ = ks.Counter(), ks.Counter()
    ks.per_call_shapes(k1_act=k1_act, k7=k7_, **kw)
    return ks.k1_by_epilogue(k1_act), k7_


@pytest.mark.parametrize("path", ["packed", "5d", "tile_major", "stream",
                                  "rank"])
def test_every_generation_path_folds_each_dit_block(ks, path):
    """12 K1 launches with the modulate and 12 K7 a 638850 UNet call on
    every generation path (2 DiT norms and 2 gated residuals in each of
    6 blocks), at the DiT blocks' token maps; K1's other launches keep no
    epilogue."""
    kw = {"packed": {}, "5d": dict(packed=False),
          "tile_major": dict(patches=25, chunk=5),
          "stream": dict(patches=81, chunk=5),
          "rank": dict(grid=(5, 9))}[path]
    by_epi, k7_ = per_call(ks, **kw)
    assert by_epi["modulate"] == 12 and sum(k7_.values()) == 12
    assert by_epi["none"] == (71 if path == "5d" else 14)
    assert {c for _, c in k7_} == {256, 512}
    assert all(ks.variant("K7", s) == "vector" for s in k7_)


def test_block_major_step_and_chain_launches(ks):
    """300 of each a block-major step (25 UNet calls), 12 a call times
    ``CHAIN_LAUNCHES``' calls on every chip_smoke path, the int8 model
    included; the eager bytes the fold removes."""
    import chip_smoke as cs
    k1_act, k7_ = ks.Counter(), ks.Counter()
    ks.per_call_shapes(k1_act=k1_act, k7=k7_)
    assert ks.k1_by_epilogue(k1_act, 25)["modulate"] == 300
    assert sum(k7_.values()) * 25 == 300
    assert set(k7_) == set(cs.dit_shapes()) == {
        (41472, 256), (32768, 256), (10368, 512)}
    for path, want in cs.CHAIN_LAUNCHES.items():
        assert want["gated_residual"] * 26 == want["rmsnorm"] * 12 or \
            path == "5d", path
    assert cs.CHAIN_LAUNCHES["5d"]["gated_residual"] == 12 * 125
    k12 = tuple(ks.Counter() for _ in range(7))
    ks.quant_shapes("int8", k12=k12)
    assert ks.k1_by_epilogue(k12[5])["modulate"] == 12
    assert sum(k12[6].values()) == 12
    fold = ks.dit_fold_bytes(k1_act, k7_, 25)
    eager = fold["modulate"] + fold["gated residual"]
    assert round(eager / 1e9, 2) == 72.39
    assert round((eager - fold["K1 modulate"] - fold["K7"]) / 1e9, 2) \
        == 41.37


def test_training_folds_nothing(ks):
    """Training records autograd: no K7 and no K1 with the modulate, 5D
    and packed."""
    for packed in (False, True):
        k1_act, k7_ = ks.Counter(), ks.Counter()
        ks.train_shapes(packed, k1_act=k1_act, k7=k7_)
        assert not k7_
        assert ks.k1_by_epilogue(k1_act)["modulate"] == 0
    pred = ks.train_prediction(ks.preset_conf())
    assert pred["gated_residual"]["launches"] == 0
    assert pred["rmsnorm"]["by_epilogue"]["modulate"] == 0


def test_chip_smoke_counts_are_kernel_shapes(ks):
    """chip_smoke.py's per-call counts (from the model's DiT blocks) and
    chain predictions are kernel_shapes.py's; phase 19's DiT rows are the
    presets' new (rows, C)."""
    import chip_smoke as cs
    from tera_mind_tpu_torch.models.unet_packed import make_packed_model
    with torch.device("meta"):
        model = make_packed_model(ks.preset_conf().make_model_conf())
    _, k7_ = per_call(ks)
    assert cs.per_call_counts(model)[7] == ks.by_variant("K7", k7_) == {
        "scalar": 0, "vector": 12}
    want, variants = cs.expected_launches(cs.per_call_counts(model), 125)
    assert want == cs.CHAIN_LAUNCHES["packed"]
    assert variants["rmsnorm_epilogue"] == {"none": 14 * 125,
                                            "modulate": 12 * 125}
    pred = ks.chain_prediction(ks.preset_conf(), steps=1)
    assert pred["gated_residual"]["launches"] == 300
    assert pred["rmsnorm"]["by_epilogue"] == {"none": 350, "modulate": 300}
    shapes = [s for s, _ in cs.preset_kernel_shapes(ks)["DiT"]]
    assert len(shapes) == len(set(shapes)) == 8
    assert not set(shapes) & set(cs.dit_shapes())

"""The port's ops against the JAX package's, on the CPU.

Collage ops are pure reshapes and must match exactly.  The kernels' plain
PyTorch versions (what a CPU tensor runs, and what chip_smoke.py holds the
CUDA kernels against on the card) are checked against the JAX kernels'
own plain references, ``_rmsnorm_xla`` and ``_attention_xla``: Pallas-TPU
kernels do not run on the CPU.  The CUDA kernels themselves need the card
and are checked by chip_smoke.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tera_mind_tpu.ops import collage as jcol
from tera_mind_tpu.ops.attention_kernel import _attention_xla
from tera_mind_tpu.ops.rmsnorm_kernel import _rmsnorm_xla
from tera_mind_tpu_torch.ops import _build
from tera_mind_tpu_torch.ops import attention_kernel as k2
from tera_mind_tpu_torch.ops import collage as tcol
from tera_mind_tpu_torch.ops import rmsnorm_kernel as k1


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name,args,shape", [
    ("patchify", (16,), (2, 48, 32, 3)),
    ("unpatchify", (3, 2), (12, 16, 16, 3)),
    ("to_collage", (3, 3), (18, 2, 8, 8, 5)),
    ("pixels_to_voxels", (2,), (2, 8, 8, 6)),
    ("voxels_to_pixels", (), (2, 2, 8, 8, 3)),
])
def test_collage_ops_match_jax_exactly(name, args, shape):
    x = randn(0, *shape)
    got = getattr(tcol, name)(torch.from_numpy(x), *args)
    want = np.asarray(getattr(jcol, name)(jnp.asarray(x), *args))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [64, 741])
def test_rmsnorm_plain_f32_matches_jax(c):
    x = 3.0 * randn(1, 37, c)                     # odd row count
    w = 1.0 + 0.2 * randn(2, c)
    got = k1.rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(_rmsnorm_xla(jnp.asarray(x), jnp.asarray(w), 1e-6))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("c", [64, 741])
def test_rmsnorm_plain_bf16_matches_jax(c):
    """Both round after each multiply; the f32 statistics may differ in
    the last place, so at most 1 bf16 ulp apart."""
    x = (3.0 * randn(3, 37, c)).astype(ml_dtypes.bfloat16)
    w = (1.0 + 0.2 * randn(4, c)).astype(ml_dtypes.bfloat16)
    got = k1.rmsnorm_plain(torch.from_numpy(x.astype(np.float32)).bfloat16(),
                           torch.from_numpy(w.astype(np.float32)).bfloat16())
    want = np.asarray(_rmsnorm_xla(jnp.asarray(x), jnp.asarray(w), 1e-6))
    assert got.dtype == torch.bfloat16 and want.dtype == x.dtype
    got, want = got.float().numpy(), want.astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("b,n,d", [(3, 128, 256), (2, 32, 512), (2, 100, 48)])
def test_attention_plain_matches_jax(b, n, d):
    q, k, v = (randn(s, b, n, d) for s in (5, 6, 7))
    got = k2.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                             1.0 / d)
    want = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), 1.0 / d))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_wrappers_route_cpu_to_plain_and_count_no_launch():
    x, w = torch.from_numpy(randn(8, 5, 3, 24)), torch.ones(24)
    q = torch.from_numpy(randn(9, 2, 16, 8))
    before = (k1.launches, k2.launches, dict(k1.launches_by_variant),
              dict(k2.launches_by_variant))
    assert torch.equal(k1.rmsnorm(x, w), k1.rmsnorm_plain(x, w))
    assert torch.equal(k2.window_attention(q, q, q, 0.125),
                       k2.attention_plain(q, q, q, 0.125))
    assert (k1.launches, k2.launches, k1.launches_by_variant,
            k2.launches_by_variant) == before


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor on another device raises: no silent plain fallback."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(RuntimeError):
        k1.rmsnorm(x, torch.ones(8, device="meta"))
    q = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(RuntimeError):
        k2.window_attention(q, q, q, 0.125)


def test_attention_kernel_rejects_unsupported_shapes():
    q = torch.empty(2, 513, 64, device="meta")
    with pytest.raises(ValueError):
        k2.attention_cuda(q, q, q, 1.0 / 64)
    q = torch.empty(2, 16, 520, device="meta")
    with pytest.raises(ValueError):
        k2.attention_cuda(q, q, q, 1.0 / 520)


def test_build_is_plain_nvcc_without_torch_headers():
    srcs = _build.sources()
    assert {p.name for p in srcs} >= {"rmsnorm.cu", "attention.cu"}
    for src in srcs:
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text, src
    for name in _build.SIGNATURES:
        assert any(f'extern "C" int {name}(' in s.read_text() for s in srcs)
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    path = _build.lib_path()
    assert path.parent == _build.BUILD_DIR and path == _build.lib_path()
    assert path.name.startswith("libtmt_kernels_") and path.suffix == ".so"


MAIN_K2 = [(324, 128, 256), (256, 128, 256), (324, 32, 512)]


@pytest.mark.parametrize("b,n,d", MAIN_K2 + [(5, 100, 48)])
def test_attention_routes_main_path_bf16_to_tensor_cores(b, n, d):
    assert k2.attention_variant(n, d, torch.bfloat16, True) == "tensor_core"
    # the same shapes in f32, or misaligned, stay on CUDA cores
    assert k2.attention_variant(n, d, torch.float32, True) == "cuda_core"
    assert k2.attention_variant(n, d, torch.bfloat16, False) == "cuda_core"


@pytest.mark.parametrize("n,d", [(17, 130), (512, 512), (129, 64),
                                 (128, 512), (16, 520)])
def test_attention_routes_other_bf16_shapes_to_cuda_cores(n, d):
    """D not a multiple of 16, N above 128, or q, k, v over 227 KB of
    shared memory (N = 128, D = 512 needs 390 KB)."""
    assert k2.attention_variant(n, d, torch.bfloat16, True) == "cuda_core"


def test_tensor_core_smem_matches_the_kernels_layout():
    src = (_build.CSRC / "attention.cu").read_text()
    common = (_build.CSRC / "common.cuh").read_text()
    assert f"kTcMaxN = {k2.TC_MAX_N};" in src
    assert f"kMaxBlockSmem = {k2.SMEM_LIMIT};" in common
    assert "tc_layout(128, 256).bytes == 202752" in src
    assert k2.tc_smem_bytes(128, 256) == 202_752   # p over q
    assert k2.tc_smem_bytes(32, 512) == 99_840     # two blocks an SM
    # N = 100 pads to 112 rows; p (112 x 120) does not fit over q (112 x 56)
    assert k2.tc_smem_bytes(100, 48) == 2 * (3 * 112 * 56 + 112 * 120)


def test_rmsnorm_routes_by_channels_and_alignment():
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    assert f"kVecMaxBytes = 32 * kVecMax * 16;" in src
    assert "kVecMax = 4;" in src and k1.VEC_MAX_ROW_BYTES == 32 * 4 * 16
    for c in (96, 64, 8, 264, 1024):
        assert k1.rmsnorm_variant(c, 2, True) == "vector", c
    for c in (741, 1253, 2050, 33, 1):
        assert k1.rmsnorm_variant(c, 2, True) == "strided", c
    assert k1.rmsnorm_variant(96, 2, False) == "strided"      # misaligned
    assert k1.rmsnorm_variant(1032, 2, True) == "strided"     # > 2 KB a row
    assert k1.rmsnorm_variant(512, 4, True) == "vector"       # f32
    assert k1.rmsnorm_variant(520, 4, True) == "strided"


def test_main_path_norms_with_c_multiple_of_8_take_the_vector_variant():
    """Every RMSNorm of the 638850 model whose C % 8 == 0 fits the vector
    variant in bf16, the count chip_smoke.py expects of the main path."""
    from tera_mind_tpu_torch.config import prep_config
    from tera_mind_tpu_torch.models.nn import RMSNorm
    with torch.device("meta"):
        model = prep_config("638850").make_model_conf().make_model()
    widths = [m.weight.numel() for m in model.modules()
              if isinstance(m, RMSNorm)]
    vec = [c for c in widths if k1.rmsnorm_variant(c, 2, True) == "vector"]
    assert len(widths) == 83
    assert vec == [c for c in widths if c % 8 == 0] and len(vec) == 77
    assert sorted({c for c in widths if c % 8}) == [485, 741, 997, 1253]


def test_ptxas_report_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119attention_kernel_tcEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119attention_kernel_tcEPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 0 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14rmsnorm_kernelIfEvPKfS1_Pfxif' for 'sm_90a'
ptxas info    : Function properties for _Z14rmsnorm_kernelIfEvPKfS1_Pfxif
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 30 registers, 400 bytes cmem[0]
"""
    assert _build.ptxas_report(log) == [
        "_ZN12_GLOBAL__N_119attention_kernel_tcEPK13__nv_bfloat16: "
        "122 registers, spill 0/0 B",
        "_Z14rmsnorm_kernelIfEvPKfS1_Pfxif: 30 registers, spill 4/12 B"]
    assert "-v" in _build.NVCC_FLAGS


def test_chip_smoke_input_sets_exceed_the_l2():
    import chip_smoke as cs
    x = torch.zeros(4)
    assert len(cs.input_sets((x,), 300 * 2 ** 20)) == 1
    sets = cs.input_sets((x, x), 3 * 2 ** 20)
    assert len(sets) == 34 and sets[0][0] is x
    assert all(s[0] is not x and torch.equal(s[0], x) for s in sets[1:])


def _k2_f64_sums(q, k, v, scale):
    """A correct K2 whose f32 sums run in another order (f64, rounded)."""
    logits = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    e = torch.exp(logits * scale - (logits * scale).amax(-1, keepdim=True))
    p = (e / e.double().sum(-1, keepdim=True).float()).to(v.dtype)
    return torch.matmul(p.double(), v.double()).float().to(q.dtype)


def _chunked_f32(a, b):
    """a @ b as tensor cores sum it: each chunk of 16 along the reduction
    axis summed exactly (f64) and rounded to f32, the chunk sums added in
    f32 in order."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 16):
        acc = acc + torch.matmul(a[..., k0:k0 + 16].double(),
                                 b[..., k0:k0 + 16, :].double()).float()
    return acc


def _k2_tensor_core_order(q, k, v, scale):
    """A correct K2 whose products run in the tensor-core kernel's order:
    q.k^T and p.v in f32 chunks of 16, p normalised, then rounded."""
    logits = _chunked_f32(q, k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    return _chunked_f32(p, v).to(q.dtype)


CORRECT_K2 = {"f64 sums": _k2_f64_sums,
              "tensor-core order": _k2_tensor_core_order}


def _to_bf16_toward_zero(x):
    return (x.float().view(torch.int32) & ~0xFFFF).view(
        torch.float32).to(torch.bfloat16)


def _k2_faults(q, k, v, scale):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return {
        "p not rounded": torch.matmul(p, v.float()).to(q.dtype),
        "p truncated": torch.matmul(_to_bf16_toward_zero(p).float(),
                                    v.float()).to(q.dtype),
        "output truncated": _to_bf16_toward_zero(pv),
        "scale halved": k2.attention_plain(q, k, v, scale / 2),
        "logits ignored": k2.attention_plain(0 * q, k, v, scale),
    }


@pytest.mark.parametrize("correct", list(CORRECT_K2))
@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("n,d", [(128, 256), (32, 512)])
def test_chip_smoke_k2_check_separates_reorder_from_faults(n, d, peaked,
                                                          correct):
    """chip_smoke.py's bf16 check of K2 passes a correct version whose sums
    run in another order (f64, or the tensor cores' chunks of 16) and
    fails each fault a bf16 kernel could have, on the main path's randn
    inputs and on peaked ones."""
    import chip_smoke as cs
    g = torch.Generator().manual_seed(n + d + peaked)
    q, k, v = cs.k2_inputs(g, 16, n, d, torch.bfloat16, "cpu", peaked)
    scale = 1.0 / d
    ref = k2.attention_plain(q, k, v, scale)
    _, spacings, share = cs.require_k2(CORRECT_K2[correct](q, k, v, scale),
                                       ref, correct)
    assert spacings <= 1.0 and share <= 2e-3
    for fault, out in _k2_faults(q, k, v, scale).items():
        with pytest.raises(cs.SmokeFailure):
            cs.require_k2(out, ref, fault)


def _k1_vector_group(c, itemsize):
    """The lanes a row gets in K1's vector variant: csrc/rmsnorm.cu's
    launch_vector, which picks one instantiation per group size."""
    nvec, g = c // (16 // itemsize), 1
    while g < 32 and g * 4 < nvec:     # kVecMax = 4
        g *= 2
    return g


def test_chip_smoke_times_main_path_shapes():
    """The shapes chip_smoke.py checks and times are ones the 5D chain
    gives the kernels (scripts/kernel_shapes.py, one UNet call on the meta
    device), every K2 shape of the main path is among them, and so is a
    shape of every vector-variant instantiation (lane group G) of K1 that
    the main path launches in bf16.  The packed chain (the CLI's default)
    launches a subset of the 5D chain's shapes: its ResBlock norms are
    GroupedRMSNorm, not K1."""
    import importlib.util

    import chip_smoke as cs
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    k1_shapes, k2_shapes = ks.per_call_shapes(packed=False)
    assert sum(k1_shapes.values()) == 83 and sum(k2_shapes.values()) == 6
    k1_packed, k2_packed = ks.per_call_shapes()
    assert sum(k1_packed.values()) == 26 and k2_packed == k2_shapes
    assert set(k1_packed) <= set(k1_shapes)
    assert set(cs.K1_SHAPES) <= set(k1_shapes)
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    assert "while (g < 32 && g * kVecMax < nvec) g *= 2;" in src
    assert "kVecMax = 4;" in src

    def groups(shapes):
        return {_k1_vector_group(c, 2) for _, c in shapes
                if k1.rmsnorm_variant(c, 2, True) == "vector"}
    assert groups(k1_shapes) == {2, 4, 8, 16, 32}
    assert groups(k1_packed) <= groups(cs.K1_SHAPES)
    assert groups(cs.K1_SHAPES) == groups(k1_shapes)
    assert set(cs.K2_SHAPES) == set(k2_shapes)
    # the stand-ins are gone again
    x = torch.ones(2, 8)
    assert torch.equal(k1.rmsnorm(x, torch.ones(8)), k1.rmsnorm_plain(
        x, torch.ones(8)))


def test_chip_smoke_times_tile_major_and_stream_shapes():
    """chip_smoke.py's shapes of the tile-major step (one tile's 5x5
    patches, 5 z-windows a call) and of the streamed 2x2-tile windows
    (9x9 patches, 5 z-windows a call) are exactly the packed model's
    shapes there (scripts/kernel_shapes.py --patches P --chunk 5), each
    launching the main path's variants, and chip_smoke's chain counts are
    26 K1 and 6 K2 a call times 300 calls."""
    import importlib.util

    import chip_smoke as cs
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    for path, patches in (("tile_major", 25), ("stream", 81)):
        k1_shapes, k2_shapes = ks.per_call_shapes(patches=patches, chunk=5)
        want_k1, want_k2 = cs.PATH_SHAPES[path]
        assert set(want_k1) == set(k1_shapes), path
        assert set(want_k2) == set(k2_shapes), path
        assert all(k1.rmsnorm_variant(c, 2, True) == "vector"
                   for _, c in want_k1)
        assert all(k2.attention_variant(n, d, torch.bfloat16, True)
                   == "tensor_core" for _, n, d in want_k2)
        assert cs.CHAIN_LAUNCHES[path] == {
            "rmsnorm": sum(k1_shapes.values()) * 300,
            "window_attention": sum(k2_shapes.values()) * 300}
    # the streamed window's rows and batches are the main path's x 5
    main_k1, main_k2 = ks.per_call_shapes()
    assert {(5 * n, c) for n, c in main_k1} == set(cs.PATH_SHAPES["stream"][0])
    assert {(5 * b, n, d) for b, n, d in main_k2} == \
        set(cs.PATH_SHAPES["stream"][1])
    with pytest.raises(ValueError):
        ks.per_call_shapes(patches=80)


# --------------------------------------------------------------------- #
# the backward kernels' plain versions and autograd Functions            #
# --------------------------------------------------------------------- #
def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _bf16_spacings(got, want):
    """max |got - want| in bf16 spacings at |want|, elementwise."""
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    return float((np.abs(np.asarray(got, np.float32) - want) / ulp).max())


@pytest.mark.parametrize("c", [64, 741])
def test_rmsnorm_bwd_plain_matches_jax_bwd(c):
    """K1b's plain version is the JAX rule ``_bwd`` term for term: f32
    within 1e-5 of each output's max, bf16 dx within one bf16 spacing
    (the weight stays f32, as in training)."""
    from tera_mind_tpu.ops.rmsnorm_kernel import _bwd
    x, g = 3.0 * randn(11, 37, c), randn(12, 37, c)
    w = 1.0 + 0.2 * randn(13, c)
    dx, dw = k1.rmsnorm_bwd_plain(*(torch.from_numpy(a) for a in (x, g, w)))
    jdx, jdw = _bwd(1e-6, (jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    assert _rel(dx.numpy(), np.asarray(jdx)) <= 1e-5
    assert _rel(dw.numpy(), np.asarray(jdw)) <= 1e-5
    xb, gb = (a.astype(ml_dtypes.bfloat16) for a in (x, g))
    dx, dw = k1.rmsnorm_bwd_plain(
        torch.from_numpy(xb.astype(np.float32)).bfloat16(),
        torch.from_numpy(gb.astype(np.float32)).bfloat16(),
        torch.from_numpy(w))
    jdx, jdw = _bwd(1e-6, (jnp.asarray(xb), jnp.asarray(w)), jnp.asarray(gb))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert _bf16_spacings(dx.float().numpy(), np.asarray(jdx)) <= 1.0
    assert _rel(dw.numpy(), np.asarray(jdw)) <= 1e-5


@pytest.mark.parametrize("b,n,d", [(3, 32, 64), (2, 17, 130)])
def test_attention_bwd_plain_matches_jax_bwd(b, n, d):
    """K2b's plain version is the JAX rule ``_bwd`` (p recomputed in f32,
    not rounded): f32 within 1e-5 of each output's max, bf16 within one
    bf16 spacing."""
    from tera_mind_tpu.ops.attention_kernel import _bwd
    q, k, v, g = (randn(s, b, n, d) for s in (21, 22, 23, 24))
    q, k = 2.0 * q, 2.0 * k     # peaked softmax rows
    got = k2.attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, g)),
                                 1.0 / d)
    want = _bwd(1.0 / d, tuple(jnp.asarray(a) for a in (q, k, v)),
                jnp.asarray(g))
    for a, w in zip(got, want):
        assert _rel(a.numpy(), np.asarray(w)) <= 1e-5
    qb, kb, vb, gb = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v, g))
    got = k2.attention_bwd_plain(
        *(torch.from_numpy(a.astype(np.float32)).bfloat16()
          for a in (qb, kb, vb, gb)), 1.0 / d)
    want = _bwd(1.0 / d, tuple(jnp.asarray(a) for a in (qb, kb, vb)),
                jnp.asarray(gb))
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert _bf16_spacings(a.float().numpy(), np.asarray(w)) <= 1.0


def test_rmsnorm_function_gradient_is_the_plain_gradient():
    """The dispatcher's autograd.Function (on the CPU: the plain forward
    and the plain ``_bwd``) passes gradcheck in f64 and equals autograd
    through ``rmsnorm_plain``."""
    x = torch.from_numpy(randn(31, 3, 5, 12)).double().requires_grad_()
    w = torch.from_numpy(1 + 0.2 * randn(32, 12)).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: k1.rmsnorm(a, b), (x, w))
    g = torch.from_numpy(randn(33, 3, 5, 12)).double()
    got = torch.autograd.grad(k1.rmsnorm(x, w), (x, w), g)
    want = torch.autograd.grad(k1.rmsnorm_plain(x, w), (x, w), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_attention_function_gradient_is_the_plain_gradient():
    q, k, v = (torch.from_numpy(randn(s, 2, 9, 6)).double().requires_grad_()
               for s in (34, 35, 36))
    assert torch.autograd.gradcheck(
        lambda a, b, c: k2.window_attention(a, b, c, 0.3), (q, k, v))
    g = torch.from_numpy(randn(37, 2, 9, 6)).double()
    got = torch.autograd.grad(k2.window_attention(q, k, v, 0.3), (q, k, v), g)
    want = torch.autograd.grad(k2.attention_plain(q, k, v, 0.3), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_dispatchers_take_the_function_only_when_autograd_records():
    """With an input that requires grad under grad mode, the dispatchers
    go through their Functions (a backward node, no launch on the CPU);
    under no_grad, or without such an input, the plain forward with no
    node; the raw CUDA launchers keep their guard."""
    x = torch.from_numpy(randn(38, 6, 16))
    w = torch.nn.Parameter(torch.ones(16))
    before = (k1.launches, k1.bwd.launches, k2.launches, k2.bwd.launches)
    y = k1.rmsnorm(x, w)
    assert type(y.grad_fn).__name__ == "RMSNormFunctionBackward"
    y.sum().backward()
    assert torch.equal(w.grad, k1.rmsnorm_bwd_plain(x, torch.ones_like(x),
                                                    w)[1])
    with torch.no_grad():
        assert k1.rmsnorm(x, w).grad_fn is None
    q = torch.from_numpy(randn(39, 2, 8, 4)).requires_grad_()
    o = k2.window_attention(q, q, q, 0.25)
    assert type(o.grad_fn).__name__ == "AttentionFunctionBackward"
    assert k2.window_attention(q.detach(), q.detach(), q.detach(),
                               0.25).grad_fn is None
    assert (k1.launches, k1.bwd.launches, k2.launches,
            k2.bwd.launches) == before
    with pytest.raises(RuntimeError, match="K1b and K2b"):
        k1.rmsnorm_cuda(torch.empty(2, 8, device="meta"),
                        torch.nn.Parameter(torch.ones(8, device="meta")))
    with pytest.raises(RuntimeError):   # no path for the meta device
        k1.rmsnorm(torch.empty(2, 8, device="meta"), w)


def test_backward_constants_match_the_kernels():
    src = (_build.CSRC / "rmsnorm_bwd.cu").read_text()
    assert f"kBwdWarps = {k1.BWD_WARPS};" in src
    assert "kMaxBlocks = 8 * 132;" in src and k1.BWD_MAX_BLOCKS == 8 * 132
    assert k1.BWD_MAX_C == 232_448 // (4 * k1.BWD_WARPS)
    assert k1.bwd_blocks(1) == 1 and k1.bwd_blocks(17) == 3
    assert k1.bwd_blocks(10 ** 6) == k1.BWD_MAX_BLOCKS
    attn = (_build.CSRC / "attention_bwd.cu").read_text()
    assert "constexpr int kMaxN = 512;" in attn
    assert "constexpr int kMaxD = 512;" in attn
    assert {p.name for p in _build.sources()} >= {"rmsnorm_bwd.cu",
                                                  "attention_bwd.cu"}
    assert set(_build.SIGNATURES) >= {"tmt_rmsnorm_bwd",
                                      "tmt_window_attention_bwd"}


def test_chip_smoke_checks_the_training_shapes_and_counts():
    """chip_smoke.py's K1b/K2b shapes are exactly the shapes one training
    step of the preset gives K1 and K2 (scripts/kernel_shapes.py
    --train), and its per-step launch counts are the script's, for the
    5D and the packed model (whose K1 shapes are the first four)."""
    import importlib.util

    import chip_smoke as cs
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    for packed, path in ((False, "5d"), (True, "packed")):
        k1_shapes, k2_shapes = ks.train_shapes(packed)
        assert cs.TRAIN_LAUNCHES[path] == {
            "rmsnorm": sum(k1_shapes.values()) * ks.TRAIN_ACCUM,
            "window_attention": sum(k2_shapes.values()) * ks.TRAIN_ACCUM}
        assert set(cs.TRAIN_K2_SHAPES) == set(k2_shapes)
        if packed:
            assert set(k1_shapes) == set(cs.TRAIN_K1_SHAPES[:4])
        else:
            assert set(k1_shapes) == set(cs.TRAIN_K1_SHAPES)
            assert len(cs.TRAIN_K1_SHAPES) == len(k1_shapes)
    assert max(c for _, c in cs.TRAIN_K1_SHAPES) <= k1.BWD_MAX_C


def test_chip_smoke_checks_the_int8_shapes_and_counts():
    """chip_smoke.py's K3 and K4 shapes are exactly the shapes one UNet
    call of ``cli.generate --quant int8`` gives them (scripts/kernel_shapes.py
    --quant, the same with int8_static), and its int8 chain counts are
    those launches times 375 calls: 75 K3, 117 K4 (and as many abs-max
    launches when dynamic, none when static), 42 torch._int_mm."""
    import importlib.util

    import chip_smoke as cs
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    for quant, variant in (("int8", "dynamic"), ("int8_static", "static")):
        k3, k4, mm = ks.quant_shapes(quant)
        assert set(cs.K3_SHAPES) == set(k3)
        assert {(r, c, m) for r, c, m, _ in k4} == set(cs.K4_SHAPES)
        assert {v for *_, v in k4} == {variant}
        want = cs.QUANT_LAUNCHES[quant]
        assert want["quant_conv"] == {"dequant": sum(k3.values()) * 375,
                                      "int32": 0}
        assert sum(k3.values()) == 75
        assert want["quantize"][variant] == sum(k4.values()) * 375
        assert sum(want["quantize"].values()) == 117 * 375
        assert want["absmax"] == (sum(k4.values()) * 375
                                  if variant == "dynamic" else 0)
        assert sum(mm.values()) == 42
    # K3's 16-channel multiple: the deep concats are padded, the others not
    assert {ci for (_, ci), _ in [((x[:3], x[3]), w) for x, w in
                                  cs.K3_SHAPES] if ci % 16} == {
        970, 1482, 1994, 2506}
    # no torch._int_mm shape needs padding beyond K's (M > 16, N % 8 == 0)
    assert all(m > 16 and k % 8 == 0 and n % 8 == 0 for m, k, n in mm)


def test_chip_smoke_checks_the_extraction_shape_and_count():
    """chip_smoke.py's K1 shape of ``cli.attn`` and its launches a tile are
    what the extractor gives K1 (scripts/kernel_shapes.py --attn): one
    (3,664, 64) float32 q-norm per z-group, 4 a tile, the vector
    variant; 1,024 over the 16x16-tile ROI."""
    import importlib.util

    import chip_smoke as cs
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    k1_shapes, patches = ks.attn_shapes()
    assert patches == 16
    assert dict(k1_shapes) == {cs.ATTN_K1_SHAPE: cs.ATTN_K1_PER_TILE}
    assert cs.ATTN_ROI_SIDE ** 2 == ks.ATTN_ROI_TILES
    assert cs.ATTN_ROI_SIDE ** 2 * cs.ATTN_K1_PER_TILE == 1024
    assert k1.rmsnorm_variant(cs.ATTN_K1_SHAPE[1], 4, True) == "vector"

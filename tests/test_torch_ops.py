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
    before = (k1.launches, k2.launches)
    assert torch.equal(k1.rmsnorm(x, w), k1.rmsnorm_plain(x, w))
    assert torch.equal(k2.window_attention(q, q, q, 0.125),
                       k2.attention_plain(q, q, q, 0.125))
    assert (k1.launches, k2.launches) == before


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


def _k2_f64_sums(q, k, v, scale):
    """A correct K2 whose f32 sums run in another order (f64, rounded)."""
    logits = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    e = torch.exp(logits * scale - (logits * scale).amax(-1, keepdim=True))
    p = (e / e.double().sum(-1, keepdim=True).float()).to(v.dtype)
    return torch.matmul(p.double(), v.double()).float().to(q.dtype)


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


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("n,d", [(128, 256), (32, 512)])
def test_chip_smoke_k2_check_separates_reorder_from_faults(n, d, peaked):
    """chip_smoke.py's bf16 check of K2 passes a correct version whose sums
    run in another order and fails each fault a bf16 kernel could have, on
    the main path's randn inputs and on peaked ones."""
    import chip_smoke as cs
    g = torch.Generator().manual_seed(n + d + peaked)
    q, k, v = cs.k2_inputs(g, 16, n, d, torch.bfloat16, "cpu", peaked)
    scale = 1.0 / d
    ref = k2.attention_plain(q, k, v, scale)
    _, spacings, share = cs.require_k2(_k2_f64_sums(q, k, v, scale), ref,
                                       "f64 sums")
    assert spacings <= 1.0 and share <= 2e-3
    for fault, out in _k2_faults(q, k, v, scale).items():
        with pytest.raises(cs.SmokeFailure):
            cs.require_k2(out, ref, fault)

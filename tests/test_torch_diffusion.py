"""The port's schedule, sampler step and initial noise against the JAX
package's, on the CPU.  Schedule constants come from the same float64
numpy maths cast to float32, so they match exactly; step maths runs in
float32 on both sides (1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tera_mind_tpu.data import noise as jnoise
from tera_mind_tpu.diffusion import sampler as jsampler
from tera_mind_tpu.diffusion import schedule as jsched
from tera_mind_tpu.ops.collage import to_collage as jto_collage
from tera_mind_tpu_torch.data import noise as tnoise
from tera_mind_tpu_torch.diffusion import sampler as tsampler
from tera_mind_tpu_torch.diffusion import schedule as tsched
from tera_mind_tpu_torch.ops.collage import to_collage as tto_collage


@pytest.mark.parametrize("name", ["linear", "cosine", "const0.01"])
def test_named_beta_schedule_matches_jax(name):
    np.testing.assert_array_equal(tsched.named_beta_schedule(name, 200),
                                  jsched.named_beta_schedule(name, 200))


@pytest.mark.parametrize("counts", ["ddim15", "ddim3", "10,5", [7]])
def test_space_timesteps_matches_jax(counts):
    assert tsched.space_timesteps(1000, counts) == \
        jsched.space_timesteps(1000, counts)


@pytest.mark.parametrize("counts", ["ddim15", "ddim3"])
def test_spaced_schedule_constants_exact(counts):
    got = tsched.spaced_schedule("linear", 1000, counts)
    want = jsched.spaced_schedule("linear", 1000, counts)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, int):
            assert a == b, f.name
        else:
            assert a.dtype == (torch.int64 if f.name == "timestep_map"
                               else torch.float32), f.name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)


def test_ddim_step_and_model_t_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    eps = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 1, 5, 9, 14, 14], np.int32)
    ts, js = (tsched.spaced_schedule("linear", 1000, "ddim15"),
              jsched.spaced_schedule("linear", 1000, "ddim15"))
    got = ts.ddim_step(torch.from_numpy(x), torch.from_numpy(t).long(),
                       torch.from_numpy(eps))
    want = js.ddim_step(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
    np.testing.assert_array_equal(ts.model_t(torch.from_numpy(t).long()),
                                  np.asarray(js.model_t(jnp.asarray(t))))


def _mock_model(to_collage, mean):
    """Deterministic stand-in for the UNet: collage pred from x and rna."""
    def fn(xp, tm, rp, p1, p2):
        ps = xp.shape[1]
        col = to_collage(xp.reshape(xp.shape[0], 1, ps, ps, xp.shape[-1]),
                         p1, p2)[:, 0]
        r = to_collage(rp.reshape(rp.shape[0], 1, *rp.shape[1:]), p1, p2)
        bias = mean(r[:, 0])[:, None, None, None]
        return 0.1 * col + 0.01 * bias + 1e-4 * tm[0], None
    return fn


def test_denoise_step_matches_jax():
    ps, b = 8, 2
    conf = dict(patch_size=ps, gn_sz=2)
    rng = np.random.default_rng(1)
    x_pad = rng.standard_normal((b, 3 * ps, 3 * ps, 2)).astype(np.float32)
    rna = rng.integers(0, 3, (b * 9, 2, 2, 8)).astype(np.float32)
    t = np.array([2, 2], np.int32)
    tsm = tsampler.DiffusionSampler(
        tsched.spaced_schedule("linear", 1000, "ddim3"),
        tsampler.SamplerConfig(**conf))
    jsm = jsampler.DiffusionSampler(
        jsched.spaced_schedule("linear", 1000, "ddim3"),
        jsampler.SamplerConfig(**conf))
    col = rng.standard_normal((b * 4, ps, ps, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tsm._assemble_eps(torch.from_numpy(col), 3, 3).numpy(),
        np.asarray(jsm._assemble_eps(jnp.asarray(col), 3, 3)))
    got = tsm.denoise_step(
        _mock_model(tto_collage, lambda r: r.mean((1, 2, 3))),
        torch.from_numpy(x_pad), torch.from_numpy(rna),
        torch.from_numpy(t).long())
    want = jsm.denoise_step(
        _mock_model(jto_collage, lambda r: r.mean(axis=(1, 2, 3))),
        jnp.asarray(x_pad), jnp.asarray(rna), jnp.asarray(t))
    assert got.shape == (b, 2 * ps, 2 * ps, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("row,col,grid_w", [(1, 1, 416), (3, 7, 16)])
def test_tile_noise_is_bit_exact(row, col, grid_w):
    assert tnoise.tile_seed(row, col, grid_w) == \
        jnoise.tile_seed(row, col, grid_w)
    np.testing.assert_array_equal(
        tnoise.tile_init_noise(row, col, grid_w, (8, 8, 6)),
        jnoise.tile_init_noise(row, col, grid_w, (8, 8, 6), backend="torch"))

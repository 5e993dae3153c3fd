"""The port's last remainders against the JAX package, on the CPU:
stochastic sampling (DDPM, DDIM with eta > 0), ``convert.check_against_model``,
``constants.M2H_NAMES`` and ``utils``.

The stochastic steps take JAX's noise (drawn from its keys here and
injected), so both sides compute the same float32 formula on the same
inputs (1e-6)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diffusion import _mock_model
from test_torch_models import seeded_params

from tera_mind_tpu import constants as jconst
from tera_mind_tpu import utils as jutils
from tera_mind_tpu.config import TrainConfig as JConf
from tera_mind_tpu.diffusion import sampler as jsampler
from tera_mind_tpu.diffusion import schedule as jsched
from tera_mind_tpu.ops.collage import to_collage as jto_collage
from tera_mind_tpu_torch import constants as tconst
from tera_mind_tpu_torch import utils as tutils
from tera_mind_tpu_torch.config import TrainConfig as TConf
from tera_mind_tpu_torch.convert import (check_against_model, export_params,
                                         flax_shapes)
from tera_mind_tpu_torch.diffusion import sampler as tsampler
from tera_mind_tpu_torch.diffusion import schedule as tsched
from tera_mind_tpu_torch.ops.collage import to_collage as tto_collage
from tera_mind_tpu_torch.parallel import generator as tgen

TOL = dict(atol=1e-6, rtol=1e-6)


def t_(a, long=False):
    a = torch.from_numpy(np.asarray(a))
    return a.long() if long else a


def schedules(counts="ddim10"):
    return (tsched.spaced_schedule("linear", 1000, counts),
            jsched.spaced_schedule("linear", 1000, counts))


def step_inputs(seed=0, n=6, steps=10):
    rng = np.random.default_rng(seed)
    x, eps, noise = (rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
                     for _ in range(3))
    t = np.array([0, 1, 3, steps - 1, 0, 5], np.int32)[:n]
    return x, eps, noise, t


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# schedule
# --------------------------------------------------------------------------

def test_q_posterior_mean_matches_jax():
    ts, js = schedules()
    x, x0, _, t = step_inputs(1)
    close(ts.q_posterior_mean(t_(x0), t_(x), t_(t, True)),
          js.q_posterior_mean(jnp.asarray(x0), jnp.asarray(x),
                              jnp.asarray(t)))


@pytest.mark.parametrize("eta", [0.3, 1.0])
def test_ddim_step_with_eta_matches_jax(eta):
    """DDIM with eta > 0 adds sigma_t noise where t > 0 (the rows of t = 0
    get none)."""
    ts, js = schedules()
    x, eps, noise, t = step_inputs(2)
    got = ts.ddim_step(t_(x), t_(t, True), t_(eps), eta=eta,
                       noise=t_(noise))
    want = js.ddim_step(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps),
                        eta=eta, noise=jnp.asarray(noise))
    for a, b in zip(got, want):
        close(a, b)
    det = ts.ddim_step(t_(x), t_(t, True), t_(eps))[0]
    moved = (got[0] - det).abs().amax(dim=(1, 2, 3))
    assert torch.equal(moved == 0, t_(t, True) == 0)
    with pytest.raises(ValueError, match="needs noise"):
        ts.ddim_step(t_(x), t_(t, True), t_(eps), eta=eta)


def test_ddpm_step_matches_jax():
    ts, js = schedules([10])
    x, eps, noise, t = step_inputs(3)
    got = ts.ddpm_step(t_(x), t_(t, True), t_(eps), t_(noise))
    want = js.ddpm_step(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps),
                        jnp.asarray(noise))
    for a, b in zip(got, want):
        close(a, b)


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

SAMPLERS = [("ddim", 0.5, "ddim4"), ("ddpm", 0.0, [4])]


def samplers(gen_type, eta, counts, ps=8):
    conf = dict(patch_size=ps, gn_sz=2, gen_type=gen_type, eta=eta)
    return (tsampler.DiffusionSampler(
                tsched.spaced_schedule("linear", 1000, counts),
                tsampler.SamplerConfig(**conf)),
            jsampler.DiffusionSampler(
                jsched.spaced_schedule("linear", 1000, counts),
                jsampler.SamplerConfig(**conf)))


MODELS = (_mock_model(tto_collage, lambda r: r.mean((1, 2, 3))),
          _mock_model(jto_collage, lambda r: r.mean(axis=(1, 2, 3))))


@pytest.mark.parametrize("gen_type,eta,counts", SAMPLERS)
def test_stochastic_denoise_step_matches_jax(gen_type, eta, counts):
    """One stochastic step with the noise JAX draws from its key."""
    ps, b = 8, 2
    tsm, jsm = samplers(gen_type, eta, counts, ps)
    rng = np.random.default_rng(4)
    x_pad = rng.standard_normal((b, 3 * ps, 3 * ps, 2)).astype(np.float32)
    rna = rng.integers(0, 3, (b * 9, 2, 2, 8)).astype(np.float32)
    t = np.array([2, 2], np.int32)
    key = jax.random.PRNGKey(9)
    want = jsm.denoise_step(MODELS[1], jnp.asarray(x_pad), jnp.asarray(rna),
                            jnp.asarray(t), rng=key)
    noise = jax.random.normal(key, (b * 9, ps, ps, 2), jnp.float32)
    got = tsm.denoise_step(MODELS[0], t_(x_pad), t_(rna), t_(t, True),
                           noise=t_(noise))
    close(got, want)
    with pytest.raises(ValueError, match="needs noise or a generator"):
        tsm.denoise_step(MODELS[0], t_(x_pad), t_(rna), t_(t, True))
    drawn = tsm.denoise_step(MODELS[0], t_(x_pad), t_(rna), t_(t, True),
                             generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and not torch.equal(drawn, got)


@pytest.mark.parametrize("gen_type,eta,counts", SAMPLERS)
def test_stochastic_sample_matches_jax(gen_type, eta, counts):
    """The whole loop: each step's noise is JAX's normal of its key folded
    with the step, injected through ``step_noise``."""
    ps, b = 8, 2
    tsm, jsm = samplers(gen_type, eta, counts, ps)
    rng = np.random.default_rng(5)
    x_t = rng.standard_normal((b, 2 * ps, 2 * ps, 2)).astype(np.float32)
    rna = rng.integers(0, 3, (b * 9, 2, 2, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jsm.sample(MODELS[1], jnp.asarray(x_t), jnp.asarray(rna), rng=key)
    got = tsm.sample(MODELS[0], t_(x_t), t_(rna), step_noise=lambda s: t_(
        jax.random.normal(jax.random.fold_in(key, s), (b * 9, ps, ps, 2),
                          jnp.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # without injected noise: a default generator, reproducible
    a, b_ = (tsm.sample(MODELS[0], t_(x_t), t_(rna)) for _ in range(2))
    assert torch.equal(a, b_) and not torch.equal(a, got)


def test_eval_sampler_and_config_gen_type_match_jax():
    for gen_type in ("ddim", "ddpm"):
        got = TConf().make_eval_sampler(6, gen_type)
        want = JConf().make_eval_sampler(6, gen_type)
        assert got.conf.gen_type == want.conf.gen_type == gen_type
        np.testing.assert_array_equal(got.schedule.timestep_map.numpy(),
                                      np.asarray(want.schedule.timestep_map))
    assert (TConf().gen_type, TConf().mesh_shape) == (
        JConf().gen_type, JConf().mesh_shape)
    for n, m in ((1, 1), (4, 1), (8, 2)):
        assert TConf().scale_up_gpus(n, m).batch_size == \
            JConf().scale_up_gpus(n, m).batch_size == 32 * n * m


@pytest.mark.parametrize("gen_type,eta", [("ddpm", 0.0), ("ddim", 0.2)])
def test_generator_refuses_a_stochastic_sampler(gen_type, eta):
    """The tera-scale generator runs deterministic DDIM only, as JAX's."""
    tsm = tsampler.DiffusionSampler(
        tsched.spaced_schedule("linear", 1000, "ddim3"),
        tsampler.SamplerConfig(patch_size=16, gn_sz=2, gen_type=gen_type,
                               eta=eta))
    conf = tgen.GeneratorConfig(tile=32, patch=16, gn_blk=8, snum=4,
                                n_slices=4, stains=1, gdim=6)
    with pytest.raises(ValueError, match="eta=0 DDIM only"):
        tgen.TeraGenerator(tsm, MODELS[0], conf, device="cpu")
    det = tsampler.DiffusionSampler(tsm.schedule, tsampler.SamplerConfig(
        patch_size=16, gn_sz=2))
    tgen.TeraGenerator(det, MODELS[0], conf, device="cpu")


# --------------------------------------------------------------------------
# check_against_model, M2H_NAMES
# --------------------------------------------------------------------------

CONF_KW = dict(image_size=32, net_ch=8, embed_channels=32, rna_num=16,
               rna_slices=4, stain="all", compute_dtype="float32",
               net_num_res_blocks=1)


@pytest.fixture(scope="module")
def tiny_models():
    jm = JConf(**CONF_KW).make_model_conf().make_model()
    tm = TConf(**CONF_KW).make_model_conf().make_model(torch.float32)
    args = (np.zeros((4, 32, 32, 4), np.float32), np.zeros((1,), np.int32),
            np.zeros((4, 2, 2, 64), np.float32), 2, 2)
    params = jax.tree.map(np.asarray, seeded_params(jm, *args, seed=1))
    return jm, tm, args, params


def edit(params, how):
    """A copy of ``params`` with one leaf removed, added or misshapen."""
    p = jax.tree.map(np.array, params)
    stem = p["params"]["stem"]
    if how == "missing":
        del stem["bias"]
    elif how == "extra":
        stem["scale"] = np.ones(3, np.float32)
    else:
        stem["kernel"] = stem["kernel"][..., :-1]
    return p


def test_check_against_model_accepts_the_converted_params(tiny_models):
    jm, tm, args, params = tiny_models
    check_against_model(params, tm)
    check_against_model(params["params"], tm)
    check_against_model(export_params(tm), tm)
    want = {"/".join(str(k.key) for k in path): tuple(v.shape) for path, v
            in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert flax_shapes(tm) == want


@pytest.mark.parametrize("how,match", [
    ("missing", "param tree mismatch:\nmissing=.*stem/bias.*\nextra=\\[\\]"),
    ("extra", "param tree mismatch:\nmissing=\\[\\]\nextra=.*stem/scale"),
    ("misshapen", "shape mismatch at .*stem.*kernel.*: ckpt")])
def test_check_against_model_raises_as_jax(tiny_models, how, match):
    jm, tm, args, params = tiny_models
    bad = edit(params, how)
    with pytest.raises(ValueError, match=match):
        check_against_model(bad, tm)


def test_m2h_names_match_jax():
    assert tconst.M2H_NAMES == jconst.M2H_NAMES
    assert sorted(tconst.M2H_NAMES) == tconst.M2H


# --------------------------------------------------------------------------
# utils
# --------------------------------------------------------------------------

def test_throughput_arithmetic(monkeypatch):
    """The meter on a stubbed clock, and JAX's on the same clock."""
    ticks = []
    monkeypatch.setattr(tutils.time, "perf_counter", lambda: ticks.pop(0))
    got = tutils.Throughput("tiles")
    assert got.per_sec == 0.0 and got.report() == "0.0000 tiles/s"
    ticks[:] = [10.0, 12.5, 14.0, 20.0]
    got.add(5)                      # the first add starts the clock: 10
    got.add(1)
    assert got.per_sec == 6 / 2.5
    assert got.report() == "1.5000 tiles/s"       # at 14
    got.start()                     # at 20: the count restarts
    assert got.count == 0 and got.per_sec == 0.0
    rates = []
    for meter in (jutils.Throughput("x"), tutils.Throughput("x")):
        ticks[:] = [0.0, 2.0, 4.0]
        meter.add(4)
        meter.add(2)
        rates.append((meter.per_sec, meter.report()))
    assert rates[0] == rates[1] == (3.0, "1.5000 x/s")


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (33, 7, 65)])
def test_model_flops_of_a_matmul_is_xlas_count(m, k, n):
    a = np.ones((m, k), np.float32)
    b = np.ones((k, n), np.float32)
    want = jutils.model_flops(lambda x, y: x @ y, jnp.asarray(a),
                              jnp.asarray(b))
    got = tutils.model_flops(torch.matmul, t_(a), t_(b))
    assert got == want == 2 * m * n * k
    assert tutils.model_flops(torch.matmul, t_(a), t_(a)) is None


def test_trace_writes_a_chrome_trace_with_its_spans(tmp_path):
    with tutils.trace(str(tmp_path / "tr")):
        with tutils.annotate("the_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "the_span" in names
    assert any("mm" in str(n) for n in names)

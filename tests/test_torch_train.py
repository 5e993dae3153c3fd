"""The port's training path against the JAX package's, on the CPU in f32.

The narrow config of tests/test_harness.py (patch 32, ``net_ch`` 8,
``embed_channels`` 32, 16 genes, 4 RNA slices, f32, dropout 0) with seeded
non-zero flax params (so every leaf gets a gradient).  The JAX side runs
as its own tests run it (K1 and K2 through their XLA paths); the port's
kernels run their plain versions and plain backward rules.  The draws the
JAX train step makes from its PRNG key (timesteps, noise, the 2x2-block
origin) are recomputed here and injected into the port's step.

Tolerances: the loss within 1e-5; the Adam first moment (the clipped
gradient times 0.1) within 1e-4 of each leaf's max; parameters within
1e-6 where every step's gradient exceeds 1e-4 of its leaf's max and
100 times Adam's eps, else within 2 lr a step.  Adam's first step is
lr g / (|g| + eps): where |g| is at the noise floor, reassociation can
flip its sign, and where |g| is within 100 eps (the clipped gradients of
this model reach 5e-8), the update follows g's 1e-5 relative error.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import seeded_params

from tera_mind_tpu.config import TrainConfig as JConf
from tera_mind_tpu.ops.collage import patchify as jpatchify
from tera_mind_tpu.training import harness as jh
from tera_mind_tpu_torch.cli import generate as tgen_cli
from tera_mind_tpu_torch.cli import train as ttrain_cli
from tera_mind_tpu_torch.config import TrainConfig as TConf
from tera_mind_tpu_torch.convert import export_params, load_jax_params
from tera_mind_tpu_torch.ops.collage import patchify as tpatchify
from tera_mind_tpu_torch.training import harness as th

CONF_KW = dict(image_size=32, net_ch=8, embed_channels=32, rna_num=16,
               rna_slices=4, stain="all", batch_size=4, accum_batches=2,
               lr=1e-3, compute_dtype="float32", train_crop=64, dropout=0.0,
               grad_clip=1.0)
T = 1000
EPS = 1e-8    # optax's Adam eps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (see tests/test_torch_packed.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def make_batch(conf, seed=0, micro=2):
    rng = np.random.default_rng(seed)
    crop, gh = conf.train_crop, conf.train_crop // 16 + conf.gn_sz
    return {"image": rng.standard_normal(
        (conf.accum_batches, micro, crop, crop, conf.in_channels)
    ).clip(-1, 1).astype(np.float32),
        "rna": rng.integers(0, 3, (conf.accum_batches, micro, gh, gh,
                                   conf.rna_slices * conf.rna_num)
                            ).astype(np.float32)}


def jax_draws(conf, batch, key):
    """The (t, noise, block origin) of each microbatch that JAX's train
    step draws from ``key`` (training/harness.py loss_fn,
    diffusion/sampler.py training_loss)."""
    n_acc, b = batch["image"].shape[:2]
    ps = conf.image_size
    hp = conf.train_crop + ps
    out = []
    for mrng in jax.random.split(key, n_acc):
        rng_t, rng_loss, _ = jax.random.split(mrng, 3)
        t = jax.random.randint(rng_t, (b,), 0, T)
        rng_noise, rng_ix, rng_iy = jax.random.split(rng_loss, 3)
        noise = jax.random.normal(rng_noise, (b, hp, hp, conf.in_channels),
                                  jnp.float32)
        ix, iy = (int(jax.random.randint(r, (), 0, hp // ps - 1))
                  for r in (rng_ix, rng_iy))
        out.append((torch.from_numpy(np.asarray(t)).long(),
                    torch.from_numpy(np.asarray(noise)), (ix, iy)))
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_run():
    """Two EMA steps of JAX's jitted train step from a seeded state: (conf,
    batch, keys, states 0..2 as numpy trees, losses)."""
    conf = JConf(**CONF_KW)
    model = conf.make_model_conf().make_model()
    opt = jh.make_optimizer(conf)
    step = jax.jit(jh.make_train_step(model, conf.make_train_sampler(), opt,
                                      conf, ema=True))
    params = seeded_params(model, np.zeros((4, 32, 32, 4), np.float32),
                           np.zeros((1,), np.int32),
                           np.zeros((4, 2, 2, 64), np.float32), 2, 2, seed=5)
    params = jax.tree.map(jnp.asarray, params)
    state = jh.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=opt.init(params),
                          ema_params=jax.tree.map(jnp.copy, params))
    batch = make_batch(conf)
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    states, losses = [jax.tree.map(np.asarray, state)], []
    for key in keys:
        state, loss = step(state, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, key)
        states.append(jax.tree.map(np.asarray, state))
        losses.append(float(loss))
    return conf, batch, keys, states, losses


def test_train_steps_match_jax(jax_run):
    """Two accumulated (2 microbatches), clipped Adam steps with EMA from
    the JAX state carried across (``state_from_tree``) match JAX's."""
    jconf, batch, keys, jstates, jlosses = jax_run
    tr = th.Trainer(TConf(**CONF_KW), device="cpu", ema=True)
    state = tr.state_from_tree(jstates[0])
    mu_prev = None
    good = None
    lr = CONF_KW["lr"]
    for i, key in enumerate(keys):
        state, loss = tr.train_step(state, torch_batch(batch),
                                    jax_draws(jconf, batch, key))
        assert abs(float(loss) - jlosses[i]) <= 1e-5, (float(loss),
                                                        jlosses[i])
        got = tr.state_tree(state)
        want = jstates[i + 1]
        adam = want.opt_state[1][0]
        assert (got["step"], got["count"]) == (i + 1, int(adam.count)) \
            == (int(want.step), i + 1)
        mu, jmu = flat(got["mu"]), flat(adam.mu)
        assert mu.keys() == jmu.keys()
        grads = {}
        for k in jmu:
            top = np.abs(jmu[k]).max()
            assert np.abs(mu[k] - jmu[k]).max() <= 1e-4 * top, k
            g = jmu[k] if mu_prev is None else jmu[k] - 0.9 * mu_prev[k]
            grads[k] = np.abs(g)
        # Adam's eps (1e-8) enters lr g / (|g| + eps) below |g| ~ 1e-6
        mask = {k: (g > 1e-4 * g.max()) & (g > 100 * EPS)
                for k, g in grads.items()}
        good = mask if good is None else {k: good[k] & mask[k] for k in mask}
        mu_prev = jmu
        params, jparams = flat(got["params"]), flat(want.params)
        for k, p in jparams.items():
            d = np.abs(params[k] - p)
            assert d[good[k]].max(initial=0) <= 1e-6, k
            assert d.max() <= 2 * lr * (i + 1), k
        ema, jema = flat(got["ema_params"]), flat(want.ema_params)
        for k, e in jema.items():
            assert np.abs(ema[k] - e).max() <= 1e-6, k
        assert np.abs(flat(got["nu"])["/params/stem/kernel"]
                      - flat(adam.nu)["/params/stem/kernel"]).max() \
            <= 1e-4 * np.abs(flat(adam.nu)["/params/stem/kernel"]).max()


@pytest.mark.parametrize("kw", [dict(), dict(warmup=3),
                                dict(weight_decay=0.01),
                                dict(warmup=2, weight_decay=0.05,
                                     grad_clip=0.5)])
def test_optimizer_rules_match_optax(kw):
    """The port's clip -> Adam / AdamW with linear warmup against the
    JAX package's ``make_optimizer`` (optax) over 4 steps, the clip
    triggered on some of them."""
    jconf = JConf(**{**CONF_KW, "lr": 1e-2, **kw})
    tx = jh.make_optimizer(jconf)
    opt = th.make_optimizer(TConf(**{**CONF_KW, "lr": 1e-2, **kw}))
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = tx.init(jp), opt.init(tp)
    for step in range(4):
        scale = (0.05, 3.0)[step % 2]
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in
                                     grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = opt.step(tp, {k: torch.from_numpy(g) for k, g in
                               grads.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert tstate.count == 4
    assert opt.learning_rate(0) == (0.0 if kw.get("warmup") else 1e-2)


def test_packed_train_step_matches_5d():
    """``packed_compute`` trains the same function: the packed step's loss
    and parameters match the 5D step's from the same 5D params and draws
    (tests/test_harness.py::test_packed_train_step_matches_5d's bounds)."""
    conf = TConf(**CONF_KW)
    batch = make_batch(conf, seed=3)
    t5 = th.Trainer(conf, device="cpu")
    s5 = t5.init_state(seed=2)
    tp = th.Trainer(dataclasses.replace(conf, packed_compute=True),
                    device="cpu")
    sp = tp.state_from_params(export_params(t5.model))
    draws = [t5.draw(torch.zeros(2, 96, 96, 4)) for _ in range(2)]
    s5, l5 = t5.train_step(s5, torch_batch(batch), draws)
    sp, lp = tp.train_step(sp, torch_batch(batch), draws)
    np.testing.assert_allclose(float(lp), float(l5), rtol=1e-4)
    d = max(float((sp.params[n] - p).abs().max())
            for n, p in s5.params.items())
    assert d < 5e-4, d


def test_training_loss_and_sample_match_jax():
    """``training_loss`` (mse and l1) with injected noise, t and block
    origin within 1e-5, and the deterministic DDIM ``sample`` (with and
    without the gene-coverage mask) within 1e-4, on the narrow TeraUNet
    with seeded params."""
    jconf = JConf(**CONF_KW)
    jmodel = jconf.make_model_conf().make_model()
    params = seeded_params(jmodel, np.zeros((4, 32, 32, 4), np.float32),
                           np.zeros((1,), np.int32),
                           np.zeros((4, 2, 2, 64), np.float32), 2, 2, seed=6)
    tconf = TConf(**CONF_KW)
    model = load_jax_params(tconf.make_model_conf().make_model(), params)
    rng = np.random.default_rng(9)
    b, crop, ps = 2, 64, 32
    x_pad = np.pad(rng.standard_normal((b, crop, crop, 4)).clip(-1, 1),
                   ((0, 0), (16, 16), (16, 16), (0, 0))).astype(np.float32)
    rna = rng.integers(0, 3, (b, 6, 6, 64)).astype(np.float32)
    noise = rng.standard_normal(x_pad.shape).astype(np.float32)
    t = np.array([3, 870])
    samplers = {lt: (dataclasses.replace(jconf, loss_type=lt)
                     .make_train_sampler(),
                     dataclasses.replace(tconf, loss_type=lt)
                     .make_train_sampler()) for lt in ("mse", "l1")}
    eval_j = jconf.make_eval_sampler(T=2)
    eval_t = tconf.make_eval_sampler(T=2)
    mask = (rng.random((b, crop, crop, 1)) < 0.7).astype(np.float32)
    img_noise = rng.standard_normal((b, crop, crop, 4)).astype(np.float32)
    rna_pat = np.asarray(jpatchify(jnp.asarray(rna), 2))

    @jax.jit
    def jax_side(p):
        def fn(xp, tm, rp, p1, p2, **kw):
            return jmodel.apply(p, xp, tm, rp, p1, p2, **kw)
        losses = [s.training_loss(fn, x_pad, rna, t, jax.random.PRNGKey(0),
                                  noise=noise, block_idx=(1, 0))
                  for s, _ in samplers.values()]

        def col(xp, tm, rp, p1, p2):
            return fn(xp, tm, rp, p1, p2, decode_original=False)
        return losses, (eval_j.sample(col, img_noise, rna_pat),
                        eval_j.sample(col, img_noise, rna_pat, mask=mask))

    jlosses, jsamples = jax_side(params)
    with torch.no_grad():
        for (_, ts), want in zip(samplers.values(), jlosses):
            got = ts.training_loss(model, torch.from_numpy(x_pad),
                                   torch.from_numpy(rna), torch.from_numpy(t),
                                   noise=torch.from_numpy(noise),
                                   block_idx=(1, 0))
            assert abs(float(got) - float(want)) <= 1e-5

        def col(xp, tm, rp, p1, p2):
            return model(xp, tm, rp, p1, p2, decode_original=False)
        rp = tpatchify(torch.from_numpy(rna), 2)
        assert np.array_equal(rp.numpy(), rna_pat)
        for m, want in zip((None, mask), jsamples):
            got = eval_t.sample(col, torch.from_numpy(img_noise), rp,
                                mask=None if m is None
                                else torch.from_numpy(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4)
    with pytest.raises(ValueError):
        samplers["mse"][1].training_loss(
            model, torch.from_numpy(x_pad), torch.from_numpy(rna),
            torch.from_numpy(t), noise=torch.from_numpy(noise),
            block_idx=(2, 0))


def test_save_restore_is_bit_exact_and_fit_resumes(tmp_path):
    """``save`` -> ``restore`` brings back every tensor bit for bit; a
    fresh trainer's ``fit`` resumes from the newest checkpoint, which
    keeps 3; a JAX orbax-style directory is refused."""
    conf = TConf(**{**CONF_KW, "base_dir": str(tmp_path), "name": "run"})
    tr = th.Trainer(conf, device="cpu", ema=True)
    state = tr.init_state(seed=1)
    batch = torch_batch(make_batch(conf, seed=1))
    state, _ = tr.train_step(state, batch)
    path = tr.save(state)
    assert path == tmp_path / "run" / "ckpt" / "1"
    again = th.Trainer(conf, device="cpu", ema=True).restore()
    want, got = tr.state_tree(state), tr.state_tree(again)
    assert (got["step"], got["count"]) == (want["step"], want["count"]) \
        == (1, 1)
    for key in ("params", "mu", "nu", "ema_params"):
        a, b = flat(got[key]), flat(want[key])
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a), key

    fresh = th.Trainer(conf, device="cpu", ema=True)
    raw = make_batch(conf, seed=2)
    flat_batch = {k: v.reshape(-1, *v.shape[2:]) for k, v in raw.items()}
    end = fresh.fit(iter([flat_batch] * 4), max_steps=4, metrics=False)
    assert end.step == 4 and [r["step"] for r in fresh.log] == [2, 3, 4]
    for s in (5, 6):
        end.step = s
        fresh.save(end)
    assert th.checkpoint_steps(tr.ckpt_dir) == [4, 5, 6]
    orbax = tmp_path / "orbax"
    (orbax / "7").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        th.read_checkpoint(orbax)


def test_preview_writes_the_jax_grid(tmp_path):
    """``preview`` saves the generated|real grid of every z-channel of
    both stains (tests/test_harness.py::test_preview_full_channel_grid)."""
    from PIL import Image
    conf = TConf(**{**CONF_KW, "batch_size": 2, "accum_batches": 1,
                    "T_eval": 2, "sample_size": 2})
    tr = th.Trainer(conf, device="cpu")
    state = tr.init_state()
    rng = np.random.default_rng(0)
    crop, gh = conf.train_crop, conf.train_crop // 16 + conf.gn_sz
    batch = {"image": rng.standard_normal(
        (2, crop, crop, conf.in_channels)).clip(-1, 1).astype(np.float32),
        "rna": rng.integers(0, 3, (2, gh, gh, 4 * conf.rna_num)
                            ).astype(np.float32)}
    path = tr.preview(state, batch, str(tmp_path / "s"), step=1)
    im = np.asarray(Image.open(path))
    zi = conf.in_channels // 2
    assert im.shape == (2 * crop, 2 * zi * crop, 3), im.shape
    assert im[..., 0].mean() < 0.5 * min(im[..., 1].mean(),
                                         im[..., 2].mean())
    assert im[..., 1].std() > 10 and im[..., 2].std() > 10
    assert tr.model.training


def test_loss_decreases_on_a_repeated_batch():
    """A few steps on one batch with the same draws (and dropout masks)
    each step reduce the loss (tests/test_harness.py's optimizer sanity,
    there with one PRNG key for every step)."""
    conf = TConf(**{**CONF_KW, "dropout": 0.1})
    tr = th.Trainer(conf, device="cpu")
    state = tr.init_state()
    batch = torch_batch(make_batch(conf, seed=1))
    draws = [tr.draw(torch.zeros(2, 96, 96, 4)) for _ in range(2)]
    losses = []
    for _ in range(8):
        tr.dropout_gen.manual_seed(2)
        state, loss = tr.train_step(state, batch, draws)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_remat_gives_the_same_gradients_with_dropout():
    """``remat`` recomputes the UNet in the backward with the dropout
    generator restored: the same loss and gradients as without it."""
    conf = TConf(**{**CONF_KW, "dropout": 0.3})
    out = []
    for remat in (False, True):
        tr = th.Trainer(dataclasses.replace(conf, remat=remat), device="cpu")
        tr.init_state(seed=4)
        batch = torch_batch(make_batch(conf, seed=4))
        out.append(tr.loss_and_grads(batch))
    (l0, g0), (l1, g1) = out
    assert float(l0) == float(l1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7)


def test_trainer_refuses_a_mesh():
    """A list of devices in one process is refused: the port trains data
    parallel with a rank per device (tests/test_torch_train_dp.py)."""
    with pytest.raises(NotImplementedError, match="one rank per device"):
        th.Trainer(TConf(**CONF_KW), device=["cpu", "cpu"])


def test_cli_train_then_generate_on_the_cpu(tmp_path, monkeypatch):
    """``cli.train --synthetic --device cpu --max_steps 2`` at a tiny
    width writes a finite loss and a checkpoint with its config.json;
    ``cli.generate --ckpt_pth`` builds its model from that checkpoint and
    runs on it."""
    monkeypatch.chdir(tmp_path)
    state = ttrain_cli.main(["--synthetic", "--device", "cpu", "--max_steps",
                             "2", "--net_ch", "8", "--patch", "32",
                             "--batch", "64"])
    assert state.step == 2
    run = tmp_path / "checkpoints" / "638850_32_229_all_4_ours"
    assert (run / "config.json").exists()
    assert th.checkpoint_steps(run / "ckpt") == [2]
    lines = (run / "metrics.jsonl").read_text().splitlines()
    losses = [json.loads(line).get("loss") for line in lines]
    assert all(np.isfinite(v) for v in losses if v is not None)
    assert any(v is not None for v in losses)
    args = tgen_cli.parse_args(["--ckpt_pth", str(run / "ckpt"), "--device",
                                "cpu", "--synthetic", "--hnm", "1", "--wnm",
                                "1", "--tot_epoch", "2", "--no_packed"])
    gen, model, gene, origin = tgen_cli.build(args)
    assert model.conf.model_channels == 8       # from config.json
    tree = th.read_checkpoint(run / "ckpt")
    want = {k: v.astype(np.float32) for k, v in flat(tree["params"]).items()}
    got = flat(export_params(model))
    for k, v in want.items():   # bf16 weights, but time_embed's float32
        if "time_embed" not in k:
            v = torch.from_numpy(v).bfloat16().float().numpy()
        np.testing.assert_array_equal(got[k], v)
    # 4 z-slices (2 windows) instead of 50: the same code at 1/12 the work
    gconf = tgen_cli.GeneratorConfig
    monkeypatch.setattr(tgen_cli, "GeneratorConfig",
                        lambda **kw: gconf(**{**kw, "n_slices": 4}))
    out = tgen_cli.main(["--ckpt_pth", str(run / "ckpt"), "--device", "cpu",
                         "--synthetic", "--hnm", "1", "--wnm", "1",
                         "--tot_epoch", "2", "--out_dir",
                         str(tmp_path / "tiles")])
    assert out.shape == (256, 256, 8) and np.isfinite(out).all()
    with pytest.raises(SystemExit, match="--device cpu"):
        ttrain_cli.build(ttrain_cli.parse_args(["--synthetic"]))
    with pytest.raises(SystemExit, match="no gene npz"):
        ttrain_cli.build(ttrain_cli.parse_args(["--device", "cpu",
                                                "--data_path", "nowhere"]))

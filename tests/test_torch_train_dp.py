"""The port's data-parallel training against the JAX package, on the CPU.

Ranks run as subprocesses over gloo (``--device cpu``, one torch thread,
a process-group timeout of 60 s, 300 s per subprocess: a rank of the
CLI's run takes about 45 s alone and twice that beside the other test
workers), each importing
this module without JAX: the ``child_*`` functions are what a rank runs,
and they write their results into a temporary directory.  The JAX
package's multi-device tests are ``cpu_mesh`` and skip here (one CPU
device), so JAX's side is its ``Trainer.train_step`` on a one-device
``('dp',)`` mesh, which trains on the same global batch:

- 2 ranks, JAX's draws injected (each rank keeps its rows of the global
  microbatch): per-step losses within 1e-5 of JAX's, the Adam moments,
  parameters and EMA by tests/test_torch_train.py's gates; the replicas
  bit-equal after every step; the clip (which triggers at every step)
  taken on the all-reduced gradient, as one process takes it;
- dropout masks that differ by rank while the draws agree, ``mesh=False``,
  the refusal of a batch that does not split over the ranks;
- ``mp_demo``'s training tail over 2 ranks against its ``--train_ref``
  (2e-5, JAX's tests/test_multiprocess.py gate);
- ``shape_batch``'s rule against JAX's, warnings and refusals included;
- a resumed fit over 2 ranks bit-equal to an uninterrupted one, the
  checkpoints written by rank 0 alone; ``cli.train`` over 2 ranks;
- each rank's loader (``--workers`` 0 and 2) decoding only its rows of
  the one-process batch;
- ``make_mesh``'s default device.

The model is tests/test_torch_train.py's narrow config with one
ResBlock a level (JAX's train step compiles in about half a minute).
"""

import json
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from tera_mind_tpu_torch.config import TrainConfig as TConf
from tera_mind_tpu_torch.parallel import mesh as tmesh
from tera_mind_tpu_torch.parallel import mp_demo as tdemo
from tera_mind_tpu_torch.training import harness as th

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 60
RANKS = 2
STEPS = 3
KEYS = (11, 12, 13)
DP_KW = dict(image_size=32, net_ch=8, embed_channels=32, rna_num=16,
             rna_slices=4, stain="all", batch_size=4, accum_batches=2,
             lr=1e-3, compute_dtype="float32", train_crop=64, dropout=0.0,
             grad_clip=1.0, net_num_res_blocks=1)
MICRO = 4          # global samples a microbatch (2 a rank)
LOSS_TOL = 1e-5    # against JAX (tests/test_torch_train.py)
DEMO_TOL = 2e-5    # mp_demo against --train_ref (JAX's gate)
EPS = 1e-8         # Adam's eps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# running ranks
# --------------------------------------------------------------------------

def start(n: int, fn: str, *args) -> list:
    """Start ``fn(rank, n, port, *args)`` of this module in ``n`` fresh
    processes (one torch thread each); :func:`finish` waits for them."""
    port = tmesh.free_port()
    boot = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(TESTS)!r}]; "
            f"import test_torch_train_dp as t; t.{fn}(*sys.argv[1:])")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    return [subprocess.Popen(
        [sys.executable, "-c", boot, str(r), str(n), str(port),
         *map(str, args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


def finish(procs: list, what: str) -> list:
    """The outputs of ``procs``; each must exit 0 within RANK_TIMEOUT_S."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {what}:\n{out[-4000:]}"
    return outs


def join(rank, n, port) -> tuple:
    torch.set_num_threads(1)
    tmesh.multihost_init(f"127.0.0.1:{port}", int(n), int(rank),
                         device="cpu", timeout_s=GROUP_TIMEOUT_S)
    return int(rank), int(n)


def flatten(tree, prefix=""):
    """A nested tree's leaves by ``/``-joined path, copied (a CPU
    tensor's export shares its memory, which the next step updates)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(flatten(v, name) if isinstance(v, dict) else
                   {name: np.array(v)})
    return out


def unflatten(flat) -> dict:
    out = {}
    for name, v in flat.items():
        *path, leaf = name.strip("/").split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(v)
    return out


def batch_rows(batch, rank, n):
    """Rank ``rank``'s rows of an (accum, micro, ...) global batch."""
    m = batch["image"].shape[1] // n
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[:, rank * m:(rank + 1) * m])) for k, v in batch.items()}


# --------------------------------------------------------------------------
# 2 ranks against JAX, with its draws
# --------------------------------------------------------------------------

def load_inputs(d):
    with np.load(Path(d) / "inputs.npz") as f:
        data = dict(f)
    params = unflatten({k[2:]: v for k, v in data.items()
                        if k.startswith("p:")})
    batch = {k: data[k] for k in ("image", "rna")}
    draws = [[(torch.from_numpy(data[f"t{s}_{a}"]),
               torch.from_numpy(data[f"n{s}_{a}"]),
               tuple(int(v) for v in data[f"b{s}_{a}"]))
              for a in range(DP_KW["accum_batches"])] for s in range(STEPS)]
    return params, batch, draws


def port_steps(tr, params, batch, draws, rank=0, n=1) -> dict:
    """STEPS EMA steps of ``tr`` from ``params`` on its rows of ``batch``
    with the global ``draws``: losses, digests and rank 0's trees."""
    state = tr.state_from_params(params)
    out = {"losses": [], "digests": [], "trees": []}
    local = batch_rows(batch, rank, n)
    for s in range(STEPS):
        state, loss = tr.train_step(state, local, draws[s])
        out["losses"].append(float(loss))
        out["digests"].append(th.state_digest(state))
        tree = tr.state_tree(state)
        out["trees"].append({k: flatten(tree[k]) for k in
                             ("params", "mu", "nu", "ema_params")})
    return out


def first_mask(tr, batch):
    """The first dropout keep-mask of a loss of ``tr`` on its rows, and
    that loss's draws."""
    from tera_mind_tpu_torch.models import blocks
    seen = []
    real = blocks.dropout

    def spy(x, rate, generator):
        out = real(x, rate, generator)
        seen.append((out != 0).flatten()[:4096].numpy())
        return out

    blocks.dropout = spy
    try:
        x = torch.zeros(batch["image"].shape[1], 96, 96, 4)
        draw = tr.draw(x)
        tr.loss(batch["image"][0], batch["rna"][0], draw)
    finally:
        blocks.dropout = real
    return seen[0], draw


def child_dp(rank, n, port, out_dir):
    """Rank ``rank``: JAX's 3 steps with its draws over a default mesh;
    dropout masks and draws; ``mesh=False``; the batch refusal."""
    rank, n = join(rank, n, port)
    params, batch, draws = load_inputs(out_dir)
    tr = th.Trainer(TConf(**DP_KW), device="cpu", ema=True)
    assert (tr.mesh.shape, tr.rank, tr.ndp) == ((n,), rank, n)
    tmesh.reset_reduce_stats()
    res = port_steps(tr, params, batch, draws, rank, n)
    stats = dict(tmesh.reduce_stats)
    # dropout: masks of this rank's own stream, the draws every rank's
    dtr = th.Trainer(TConf(**{**DP_KW, "dropout": 0.3}), device="cpu")
    dtr.state_from_params(params)
    mask, (t, noise, block) = first_mask(dtr, batch_rows(batch, rank, n))
    # mesh=False: this rank alone, no collective
    tmesh.reset_reduce_stats()
    alone = th.Trainer(TConf(**DP_KW), device="cpu", mesh=False)
    state = alone.state_from_params(params)
    m = MICRO // n
    state, loss = alone.train_step(
        state, batch_rows(batch, rank, n),
        [(t_[rank * m:(rank + 1) * m], n_[rank * m:(rank + 1) * m], b)
         for t_, n_, b in draws[0]])
    alone_res = dict(mesh=alone.mesh, ndp=alone.ndp, loss=float(loss),
                     calls=tmesh.reduce_stats["calls"])
    try:
        th.Trainer(TConf(**{**DP_KW, "batch_size": 3}), device="cpu")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    np.savez(Path(out_dir) / f"rank{rank}.npz", mask=mask, t=t.numpy(),
             noise=noise.numpy(), block=np.asarray(block),
             **({f"{s}:{k}:{leaf}": v for s, tree in
                 enumerate(res["trees"]) for k, sub in tree.items()
                 for leaf, v in sub.items()} if rank == 0 else {}))
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
        losses=res["losses"], digests=res["digests"], stats=stats,
        backend=torch.distributed.get_backend(),
        alone=dict(alone_res, mesh=alone_res["mesh"] is None),
        refusal=refusal)))
    tmesh.shutdown()


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """JAX's seeded params, batch and draws; the 2 ranks started on them;
    meanwhile JAX's 3 steps and the port's one-process 3 steps; then the
    ranks' results.  (jax losses, jax states, one-process run, ranks'
    json, rank 0's trees, ranks' npz)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from test_torch_models import seeded_params
    from test_torch_train import jax_draws, make_batch

    from tera_mind_tpu.config import TrainConfig as JConf
    from tera_mind_tpu.training import harness as jh

    out = tmp_path_factory.mktemp("dp")
    jconf = JConf(**DP_KW)
    jtr = jh.Trainer(jconf, mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                     ema=True)
    params = seeded_params(jtr.model, np.zeros((4, 32, 32, 4), np.float32),
                           np.zeros((1,), np.int32),
                           np.zeros((4, 2, 2, 64), np.float32), 2, 2, seed=5)
    params = jax.tree.map(np.asarray, params)
    batch = make_batch(jconf, seed=3, micro=MICRO)
    keys = [jax.random.PRNGKey(k) for k in KEYS]
    draws = [jax_draws(jconf, batch, key) for key in keys]
    np.savez(out / "inputs.npz", **batch, **{
        f"p:{k}": v for k, v in flatten(params).items()}, **{
        f"{c}{s}_{a}": (v.numpy() if c != "b" else np.asarray(v))
        for s, ds in enumerate(draws) for a, d in enumerate(ds)
        for c, v in zip("tnb", d)})
    procs = start(RANKS, "child_dp", out)
    try:
        state = jax.device_put(jtr.state_from_params(
            jax.tree.map(jnp.asarray, params)), jtr._rep_sharding)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jlosses, jstates = [], []
        for key in keys:
            state, loss = jtr.train_step(state, jb, key)
            jlosses.append(float(loss))
            jstates.append(jax.tree.map(np.array, state))
        one = port_steps(th.Trainer(TConf(**DP_KW), device="cpu", ema=True),
                         params, batch, draws)
    finally:
        outs = finish(procs, "child_dp")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(RANKS)]
    npz = [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]
    trees = [{k: {} for k in ("params", "mu", "nu", "ema_params")}
             for _ in range(STEPS)]
    for key, v in npz[0].items():
        if key.count(":") == 2:
            s, k, leaf = key.split(":")
            trees[int(s)][k][leaf] = v
    return dict(jlosses=jlosses, jstates=jstates, one=one, ranks=ranks,
                trees=trees, npz=npz, params=params, batch=batch,
                draws=draws, outs=outs)


def check_moments_and_params(trees, jstates, lr):
    """tests/test_torch_train.py's gates on each step's state: the first
    moment within 1e-4 of each leaf's max, the stem's second moment
    likewise, parameters within 1e-6 where every step's gradient is above
    the noise floor (else within 2 lr a step), the EMA within 1e-6."""
    good, mu_prev = None, None
    for i, (got, want) in enumerate(zip(trees, jstates)):
        adam = want.opt_state[1][0]
        jmu = flatten(adam.mu)
        assert set(got["mu"]) == set(jmu)
        grads = {}
        for k, v in jmu.items():
            top = np.abs(v).max()
            assert np.abs(got["mu"][k] - v).max() <= 1e-4 * top, (i, k)
            g = v if mu_prev is None else v - 0.9 * mu_prev[k]
            grads[k] = np.abs(g)
        mask = {k: (g > 1e-4 * g.max()) & (g > 100 * EPS)
                for k, g in grads.items()}
        good = mask if good is None else {k: good[k] & mask[k] for k in mask}
        mu_prev = jmu
        for k, p in flatten(want.params).items():
            d = np.abs(got["params"][k] - p)
            assert d[good[k]].max(initial=0) <= 1e-6, (i, k)
            assert d.max() <= 2 * lr * (i + 1), (i, k)
        for k, e in flatten(want.ema_params).items():
            assert np.abs(got["ema_params"][k] - e).max() <= 1e-6, (i, k)
        stem = "/params/stem/kernel"
        jnu = flatten(adam.nu)[stem]
        assert np.abs(got["nu"][stem] - jnu).max() <= 1e-4 * np.abs(
            jnu).max(), i


def test_two_ranks_match_jax_train_step(dp_run):
    """3 clipped EMA steps over 2 ranks, JAX's draws injected: losses
    within 1e-5 of JAX's on a one-device ('dp',) mesh, moments,
    parameters and EMA by the one-process parity test's gates; one
    all-reduce a step over gloo."""
    for r in dp_run["ranks"]:
        assert r["backend"] == "gloo"
        np.testing.assert_allclose(r["losses"], dp_run["jlosses"],
                                   atol=LOSS_TOL, rtol=0)
        assert r["stats"]["calls"] == STEPS
        assert r["stats"]["by_route"]["gloo"] == STEPS
    check_moments_and_params(dp_run["trees"], dp_run["jstates"],
                             DP_KW["lr"])


def test_replicas_are_bit_equal_after_every_step(dp_run):
    a, b = (r["digests"] for r in dp_run["ranks"])
    assert len(a) == STEPS and a == b
    assert len(set(a)) == STEPS     # and the state moved every step


def test_clip_over_ranks_is_the_one_process_clip(dp_run):
    """The clip triggers at every step (global norm above grad_clip) and
    2 ranks take the step one process takes on the whole batch: the
    clip sees the all-reduced gradient, not a rank's."""
    params, batch, draws = (dp_run[k] for k in ("params", "batch",
                                                "draws"))
    tr = th.Trainer(TConf(**DP_KW), device="cpu", mesh=False)
    state = tr.state_from_params(params)
    for s in range(STEPS):
        _, grads = tr.loss_and_grads(batch_rows(batch, 0, 1), draws[s])
        norm = float(torch.linalg.vector_norm(torch.stack(
            [g.norm() for g in grads.values()])))
        assert norm > DP_KW["grad_clip"], (s, norm)
        state, _ = tr.train_step(state, batch_rows(batch, 0, 1), draws[s])
    one = dp_run["one"]
    np.testing.assert_allclose(dp_run["ranks"][0]["losses"], one["losses"],
                               atol=1e-6, rtol=0)
    for s in range(STEPS):
        got, want = dp_run["trees"][s], one["trees"][s]
        for k, v in want["mu"].items():
            assert np.abs(got["mu"][k] - v).max() <= 1e-4 * np.abs(
                v).max(), (s, k)


def test_dropout_masks_differ_by_rank_while_draws_agree(dp_run):
    a, b = dp_run["npz"]
    for k in ("t", "noise", "block"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["mask"].shape == b["mask"].shape
    assert 0.1 < (a["mask"] != b["mask"]).mean() < 0.9


def test_mesh_false_trains_each_rank_alone(dp_run):
    """In a process group of 2, ``mesh=False`` builds no mesh and runs no
    collective; each rank's loss is its own rows'."""
    got = [r["alone"] for r in dp_run["ranks"]]
    assert all(g["mesh"] and g["ndp"] == 1 and g["calls"] == 0
               for g in got)
    assert got[0]["loss"] != got[1]["loss"]


def test_a_batch_that_does_not_split_over_the_ranks_is_refused(dp_run):
    for r in dp_run["ranks"]:
        assert "global batch of 3" in r["refusal"]
        assert "2 ranks" in r["refusal"] and "mesh=False" in r["refusal"]


# --------------------------------------------------------------------------
# mp_demo's training tail
# --------------------------------------------------------------------------

def test_mp_demo_train_ref_defaults_to_the_card():
    """``train_ref``, an entry point of the port, runs on the card unless
    the caller asks for the CPU, as the CLI beside it does."""
    import inspect
    assert inspect.signature(tdemo.train_ref).parameters[
        "device"].default == "cuda"
    assert tdemo.parse_args([]).device == "cuda"


def test_mp_demo_train_matches_train_ref():
    """``mp_demo --train_only`` over 2 ranks: the replicas bit-equal after
    every step and the loss history within 2e-5 of the one-process
    ``--train_ref`` (JAX's tests/test_multiprocess.py gate)."""
    port = tmesh.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tera_mind_tpu_torch.parallel.mp_demo",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(i), "--device", "cpu", "--dist_timeout",
         str(GROUP_TIMEOUT_S), "--train_only"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        want = tdemo.train_ref(2, "cpu")
    finally:
        outs = finish(procs, "mp_demo --train_only")
    for i, out in enumerate(outs):
        assert (f"[mp_demo] process {i} train replicas bit-equal after each "
                f"of {tdemo.TRAIN_STEPS} steps") in out, out[-3000:]
    line = [ln for ln in outs[0].splitlines() if "train losses:" in ln][0]
    got = [float(v) for v in line.split(":")[1].split()]
    assert len(got) == len(want) == tdemo.TRAIN_STEPS
    np.testing.assert_allclose(got, want, atol=DEMO_TOL, rtol=0)


# --------------------------------------------------------------------------
# shape_batch's rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_local,accum,ndp", [
    (4, 2, 2), (3, 2, 2), (1, 2, 2), (5, 4, 2), (6, 2, 4), (3, 2, 4),
    (5, 2, 1), (0, 2, 2)])
def test_shape_batch_rule_matches_jax(monkeypatch, n_local, accum, ndp):
    """A rank's ``shape_batch`` of its ``n_local`` rows over ``ndp``
    ranks against JAX's over ``ndp`` processes of one device each (its
    process count and cross-process assembly stubbed): the same
    microbatches, the same warning, the same refusal."""
    import jax

    from tera_mind_tpu.config import TrainConfig as JConf
    from tera_mind_tpu.training import harness as jh

    kw = {**DP_KW, "accum_batches": accum}
    rng = np.random.default_rng(n_local * 10 + ndp)
    b = {"image": rng.standard_normal((n_local, 8, 8, 4)).astype(np.float32),
         "rna": rng.standard_normal((n_local, 2, 2, 6)).astype(np.float32)}
    monkeypatch.setattr(jax, "process_count", lambda: ndp)
    monkeypatch.setattr(jax, "make_array_from_process_local_data",
                        lambda sharding, v: v)
    jself = types.SimpleNamespace(
        conf=JConf(**kw), _batch_sharding=None,
        mesh=types.SimpleNamespace(devices=np.empty(ndp)) if ndp > 1
        else None)
    tself = types.SimpleNamespace(conf=TConf(**kw), ndp=ndp,
                                  device=torch.device("cpu"))
    if n_local == 0:
        with pytest.raises(AssertionError, match="batch 0 < dp devices 2"):
            jh.Trainer.shape_batch(jself, b)
        with pytest.raises(ValueError, match="batch 0 < dp devices 2"):
            th.Trainer.shape_batch(tself, b)
        return
    out = []
    for mod, me in ((jh, jself), (th, tself)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = mod.Trainer.shape_batch(me, b)
        out.append(({k: np.asarray(v) for k, v in got.items()},
                    [str(x.message) for x in w]))
    (want, jw), (got, tw) = out
    assert tw == jw
    assert (len(jw) == 1) == ((n_local, accum, ndp) in {
        (3, 2, 2), (5, 4, 2), (3, 2, 4), (5, 2, 1)})
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------
# resume and the CLI over ranks
# --------------------------------------------------------------------------

def child_resume(rank, n, port, out_dir):
    """Rank ``rank``: a fit of 2 steps resumed to 4 against 4 steps in one
    fit (mp_demo's config, dropout 0.1)."""
    rank, n = join(rank, n, port)
    out_dir = Path(out_dir)
    written = []
    real = th.write_checkpoint

    def spy(root, tree):
        written.append((Path(root).parent.parent.name, int(tree["step"])))
        return real(root, tree)

    th.write_checkpoint = spy
    per = tdemo.TRAIN_BATCH // n

    def batches():
        b = tdemo._train_batch(tdemo._train_conf(), 0, lo=rank * per,
                               hi=(rank + 1) * per)
        while True:
            yield b

    res = {}
    for run, stops in (("resumed", (2, 4)), ("whole", (4,))):
        conf = tdemo._train_conf(dropout=0.1, base_dir=str(out_dir / run))
        for stop in stops:
            state = th.Trainer(conf, device="cpu").fit(
                batches(), max_steps=stop, metrics=False)
        res[run] = th.state_digest(state)
        res[f"{run}_steps"] = th.checkpoint_steps(Path(conf.logdir) / "ckpt")
    tmesh.shutdown()
    res["written"] = written
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def child_cli(rank, n, port, out_dir):
    """Rank ``rank`` of ``cli.train.main`` at a tiny width for 2 steps,
    run in ``out_dir``."""
    from tera_mind_tpu_torch.cli import train as train_cli
    torch.set_num_threads(1)
    os.chdir(out_dir)
    state = train_cli.main([
        "--synthetic", "--device", "cpu", "--max_steps", "2", "--net_ch",
        "8", "--patch", "32", "--batch", "64", "--coordinator",
        f"127.0.0.1:{port}", "--num_processes", str(n), "--process_id",
        str(rank), "--dist_timeout", str(GROUP_TIMEOUT_S)])
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
        step=state.step, digest=th.state_digest(state))))


def run_ranks(tmp_path_factory, fn):
    out = tmp_path_factory.mktemp(fn)
    outs = finish(start(RANKS, fn, out), fn)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(RANKS)], out, outs


def test_resume_over_two_ranks_is_bit_equal(tmp_path_factory):
    """Steps 2 -> 4 resumed over 2 ranks end bit-equal to 4 steps in one
    fit, on both ranks; only rank 0 writes checkpoints."""
    ranks, out, _ = run_ranks(tmp_path_factory, "child_resume")
    for r in ranks:
        assert r["resumed"] == r["whole"]
        assert r["resumed_steps"] == [2, 4] and r["whole_steps"] == [4]
    assert ranks[0]["resumed"] == ranks[1]["resumed"]
    assert ranks[0]["written"] == [["resumed", 2], ["resumed", 4],
                                   ["whole", 4]]
    assert ranks[1]["written"] == []


def test_cli_train_over_two_ranks(tmp_path_factory):
    """``cli.train --synthetic --device cpu --max_steps 2`` over 2 ranks at
    a tiny width: the replicas equal, one checkpoint directory written by
    rank 0 with its config, a finite logged loss."""
    ranks, out, outs = run_ranks(tmp_path_factory, "child_cli")
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    run = out / "checkpoints" / "638850_32_229_all_4_ours"
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == [
        run.name]
    assert (run / "config.json").exists()
    assert th.checkpoint_steps(run / "ckpt") == [2]
    losses = [json.loads(line).get("loss") for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    assert any(v is not None for v in losses)
    assert all(np.isfinite(v) for v in losses if v is not None)
    assert "backend gloo" in outs[0]
    assert "step 1  loss" in outs[0] and "step 1  loss" not in outs[1]


# --------------------------------------------------------------------------
# each rank's loader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kind", ["synthetic", "merfish"])
def test_ranks_load_their_rows_of_the_one_process_batch(tmp_path, kind,
                                                        workers):
    """``cli.train``'s loader over 2 ranks, with and without worker
    processes: the union of the ranks' rows of each step's effective batch
    is the one-process batch in JAX's order (block r of each microbatch),
    over a pass boundary; on the MERFISH files the crops, z windows and
    augmentations are drawn in sequence, so a rank that skips rows must
    still take their draws.  A rank decodes only its own rows."""
    from test_torch_data import _merfish_fixture

    from tera_mind_tpu_torch.cli import train as train_cli
    from tera_mind_tpu_torch.data import dataset as tds
    eff, accum, steps = 8, 2, 3         # 2 batches a pass of 20 samples
    if kind == "merfish":
        paths = _merfish_fixture(tmp_path)

        def make():
            return tds.MerfishTrainDataset(paths, gdim=6, crop=32, snum=4,
                                           pad_bins=1, repeat=10, seed=7,
                                           compact=True)
    else:
        def make():
            return tds.SyntheticDataset(n=20, crop=32, gdim=4, snum=4,
                                        pad_bins=1)

    def take(**kw):
        it = train_cli.epoch_batches(make(), eff, workers=workers,
                                     accum=accum, **kw)
        return [next(it) for _ in range(steps)]

    one = take()
    ranks = [take(rank=r, ranks=RANKS) for r in range(RANKS)]
    m = eff // accum // RANKS
    for s in range(steps):
        assert len(one[s]["image"]) == eff
        for k in ("image", "rna"):
            union = np.concatenate([ranks[r][s][k][a * m:(a + 1) * m]
                                    for a in range(accum)
                                    for r in range(RANKS)])
            np.testing.assert_array_equal(union, one[s][k])
    if workers == 0:
        ds, calls = make(), []
        real = ds.sample
        ds.sample = lambda i: calls.append(i) or real(i)
        keep = train_cli.rank_positions(eff, accum, 1, RANKS)
        assert len(list(tds.batches(ds, eff, keep=keep))) == 2
        assert len(calls) == len(ds) // RANKS


# --------------------------------------------------------------------------
# the mesh's default device
# --------------------------------------------------------------------------

def test_make_mesh_defaults_to_the_card():
    """Without ``device`` the mesh (and so a generator or trainer built
    on it) is on the card; the CPU only when asked for."""
    card = (torch.device("cuda", 0) if torch.cuda.is_available()
            else torch.device("cuda"))
    assert tmesh.make_mesh(("dp",)).device == card
    assert tmesh.make_mesh(("gr", "gc"), (1, 1)).device.type == "cuda"
    assert tmesh.make_mesh(("dp",), device="cpu").device == torch.device(
        "cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_chip_smoke_rank_training_shapes_and_counts(n):
    """chip_smoke.py's phase 18 checks and times K1, K1b, K2 and K2b at a
    rank's training shapes over n ranks, scripts/kernel_shapes.py --train
    --ranks n's, and requires of each rank the one-process step's
    launches (252 K1/K1b, 18 K2/K2b) and backward variants."""
    import importlib.util

    import chip_smoke as cs
    from tera_mind_tpu_torch.ops import _build
    spec = importlib.util.spec_from_file_location(
        "kernel_shapes", _build.PKG.parent / "scripts" / "kernel_shapes.py")
    ks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ks)
    k1, k2 = ks.train_rank_shapes(n)
    k1_shapes, k2_shapes = cs.train_rank_shapes(n)
    assert set(k1_shapes) == set(k1) and len(k1_shapes) == len(k1)
    assert set(k2_shapes) == set(k2) and len(k2_shapes) == len(k2)
    assert ks.TRAIN_ACCUM * sum(k1.values()) == \
        cs.TRAIN_LAUNCHES["5d"]["rmsnorm"]
    assert ks.TRAIN_ACCUM * sum(k2.values()) == \
        cs.TRAIN_LAUNCHES["5d"]["window_attention"]
    assert ks.train_bwd_variants(batch=ks.TRAIN_BATCH // n) == \
        cs.TRAIN_BWD_VARIANTS["5d"]
    counts = cs.dp_step_counts(n)
    assert sum(counts["rmsnorm"]) == 252
    assert sum(counts["window_attention"]) == 18

"""Training harness: the train step with gradient accumulation, the
optimizer, EMA, checkpoints and in-training sampling, on one device.

Port of ``tera_mind_tpu/training/harness.py`` (which replaces the
reference's Lightning DDP stack, experiment.py:25-491):
- bf16 compute on float32 parameters, no scaler: the model is built with
  float32 master weights and casts them at use (``models/nn.py``);
- accumulation: ``accum`` microbatches, each loss backpropagated into the
  parameters' ``.grad`` (summed), then divided by ``accum``; the loss is
  averaged the same way;
- the optimizer is optax's rules written out: clip by global norm ->
  Adam, or AdamW when ``weight_decay`` > 0, with the linear warmup of
  ``optax.linear_schedule(0, lr, warmup)``;
- ``remat`` runs the UNet under non-reentrant ``torch.utils.checkpoint``
  (the reference's ``use_checkpoint``), restoring the dropout generator
  before the recompute so that it draws the same masks;
- checkpoints are the port's own format (the card's machine has no
  orbax): step-numbered directories under ``{logdir}/ckpt``, written
  through a temporary name and renamed, the newest 3 kept, each holding
  the params, the Adam moments and count and the EMA params in the flax
  naming of ``convert.export_tensors`` (``.npz``) and the step
  (``state.json``); ``fit`` writes ``{logdir}/config.json`` beside them.

Randomness comes from two ``torch.Generator``s seeded from ``conf.seed``:
one on the device (timesteps, noise, dropout masks) and one on the host
(the 2x2-block origin, a Python int the crop needs).  The JAX package
draws from PRNG keys, so the bits differ; the parity tests inject the
JAX draws (``draws=``).  A mesh or more than one device raises
``NotImplementedError`` (ROADMAP item 6).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import time
import warnings
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrainConfig
from ..convert import (export_tensors, jax_tree_to_named, load_jax_params,
                       train_state_tree)
from ..models.nn import channels_last_, init_weights
from ..models.unet_packed import make_packed_model
from ..ops.collage import patchify

KEEP_CHECKPOINTS = 3
IMAGE_SCALE = float(np.float32(1.0 / 127.5))   # x * (1/127.5) - 1


@dataclasses.dataclass
class AdamState:
    count: int                          # optax's count: steps taken
    mu: Dict[str, torch.Tensor]         # first moments, by parameter name
    nu: Dict[str, torch.Tensor]         # second moments


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]     # the model's own parameters
    opt_state: AdamState
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def decode_batch(image: torch.Tensor, rna: torch.Tensor):
    """Compact-transfer decode (bit-exact, ``data/dataset.py``
    ``compact=True``): RAW uint8 microscopy -> float32 [-1, 1] by the
    host loader's x * (1/127.5) - 1, integer gene counts -> float32
    (exact below 2^24); float inputs are only cast."""
    if image.dtype == torch.uint8:
        image = image.float() * IMAGE_SCALE - 1.0
    else:
        image = image.float()
    return image, rna.float()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax ``chain(clip_by_global_norm(grad_clip), adam(lr))`` (``adamw``
    when ``weight_decay`` > 0), with ``linear_schedule(0, lr, warmup)``
    when ``warmup`` > 0, written out on float32 tensors."""

    lr: float
    warmup: int = 0
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()})

    def learning_rate(self, count: int) -> float:
        """The schedule at optax's count (the steps before this one),
        in float32 as ``polynomial_schedule`` computes it."""
        if self.warmup <= 0:
            return self.lr
        c = np.float32(min(max(count, 0), self.warmup))
        frac = np.float32(1.0) - c / np.float32(self.warmup)
        return float(np.float32(0.0 - self.lr) * frac + np.float32(self.lr))

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """``clip_by_global_norm``: g, or g * (grad_clip / |g|) when the
        global norm |g| is not below ``grad_clip`` (optax divides by |g|
        and then multiplies, one rounding apart), without a host sync."""
        if self.grad_clip <= 0:
            return grads
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamState) -> AdamState:
        """Apply one update to ``params`` in place; returns the new state
        (its moment tensors updated in place too).  Each rule is one
        ``torch._foreach_*`` call over all leaves (a few launches a step,
        not a few per leaf), in optax's order of operations."""
        names = list(params)
        p = [params[n] for n in names]
        g = self.clip([grads[n] for n in names])
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        count = state.count + 1
        lr = self.learning_rate(state.count)
        # bias corrections 1 - b ** count in float32, as optax takes them
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(count))
                    for b in (self.b1, self.b2))
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - self.b2))
        # update = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p]
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, den)
        if self.weight_decay > 0:
            torch._foreach_add_(update, torch._foreach_mul(
                p, self.weight_decay))
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(p, update)
        return AdamState(count=count, mu=state.mu, nu=state.nu)


def make_optimizer(conf: TrainConfig) -> Optimizer:
    return Optimizer(lr=conf.lr, warmup=conf.warmup,
                     weight_decay=conf.weight_decay, grad_clip=conf.grad_clip)


# ------------------------------------------------------------------ #
# checkpoint format                                                   #
# ------------------------------------------------------------------ #
def _flat(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v)})
    return out


def _unflat(flat) -> Dict:
    out: Dict = {}
    for name in flat.files:
        *path, leaf = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = flat[name]
    return out


def checkpoint_steps(root: str | Path) -> List[int]:
    """The steps of the port checkpoints under ``root``, ascending."""
    root = Path(root)
    if not root.is_dir():
        return []
    return sorted(int(d.name) for d in root.iterdir()
                  if d.name.isdigit() and (d / "state.json").exists())


def write_checkpoint(root: str | Path, tree: Dict) -> Path:
    """Write a checkpoint tree (``convert.train_state_tree``'s format) as
    ``root/{step}``: into a temporary directory, then renamed; keeps the
    newest ``KEEP_CHECKPOINTS``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    step = int(tree["step"])
    tmp = root / f".tmp_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    for key in ("params", "mu", "nu", "ema_params"):
        if tree.get(key) is not None:
            np.savez(tmp / f"{key}.npz", **_flat(tree[key]))
    (tmp / "state.json").write_text(json.dumps(
        {"step": step, "count": int(tree["count"]),
         "ema": tree.get("ema_params") is not None}))
    final = root / str(step)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in checkpoint_steps(root)[:-KEEP_CHECKPOINTS]:
        shutil.rmtree(root / str(old))
    return final


def read_checkpoint(root: str | Path, step: Optional[int] = None) -> Dict:
    """The checkpoint tree of ``step`` (default: the newest) under
    ``root``.  A directory without port checkpoints raises: an orbax
    directory of the JAX trainer ``NotImplementedError``, anything else
    ``FileNotFoundError``."""
    root = Path(root)
    steps = checkpoint_steps(root)
    if not steps:
        if root.is_dir() and any(d.name.isdigit() for d in root.iterdir()):
            raise NotImplementedError(
                f"{root}: an orbax checkpoint of the JAX trainer? The port "
                "reads its own checkpoints only (no orbax on the card's "
                "machine)")
        raise FileNotFoundError(f"no port checkpoint under {root}")
    d = root / str(steps[-1] if step is None else step)
    meta = json.loads((d / "state.json").read_text())
    tree = {"step": meta["step"], "count": meta["count"],
            "ema_params": None}
    for key in ("params", "mu", "nu", "ema_params"):
        if (d / f"{key}.npz").exists():
            with np.load(d / f"{key}.npz") as f:
                tree[key] = _unflat(f)
    return tree


# ------------------------------------------------------------------ #
# the trainer                                                          #
# ------------------------------------------------------------------ #
class Trainer:
    """Orchestrates init/resume, the step loop, checkpoints and sampling
    on one device (``cuda`` by default; the CPU for the tests)."""

    def __init__(self, conf: TrainConfig, *, device="cuda", ema: bool = False,
                 mesh=None):
        if mesh not in (None, False) or isinstance(device, (list, tuple)):
            raise NotImplementedError(
                "data-parallel training over a mesh or several devices is "
                "not ported yet (ROADMAP item 6); train on one device")
        self.conf = conf
        self.device = torch.device(device)
        mconf = conf.make_model_conf()
        if conf.packed_compute:
            # the packed layout on the 5D parameters: the same weights and
            # checkpoints as TeraUNet
            model = make_packed_model(mconf, torch.float32, from_5d=True,
                                      packed_attn=conf.packed_attn)
        else:
            model = mconf.make_model(torch.float32)
        model = model.to(self.device)
        if self.device.type == "cuda":
            model = channels_last_(model)
        self.model = model.train()
        self.sampler = conf.make_train_sampler().to(self.device)
        self.eval_sampler = conf.make_eval_sampler().to(self.device)
        self.optimizer = make_optimizer(conf)
        self.ema = ema
        self.gen = torch.Generator(self.device).manual_seed(conf.seed)
        self.host_gen = torch.Generator().manual_seed(conf.seed)
        self.log: List[dict] = []     # per step: loss, data_s, step_s

    @property
    def ckpt_dir(self) -> Path:
        return Path(self.conf.logdir) / "ckpt"

    # ---------------- state ----------------
    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _fresh_state(self) -> TrainState:
        params = self._params()
        ema = ({n: p.detach().clone() for n, p in params.items()}
               if self.ema else None)
        return TrainState(step=0, params=params,
                          opt_state=self.optimizer.init(params),
                          ema_params=ema)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """A fresh state from the port's seeded init (``init_weights``;
        the JAX package's ``model.init`` draws other bits from the same
        seed, and needs a sample batch for its shapes, which the port's
        modules know)."""
        init_weights(self.model, self.conf.seed if seed is None else seed)
        n = sum(p.numel() for p in self.model.parameters())
        print(f"Model params: {n / 1e6:.2f} M", flush=True)
        return self._fresh_state()

    def state_from_params(self, params: Dict) -> TrainState:
        """A fresh state (step 0, fresh optimizer) around PRETRAINED
        flax-named params: the reference's pretrain/``continue_from``
        init, as opposed to :meth:`restore`."""
        load_jax_params(self.model, params)
        n = sum(p.numel() for p in self.model.parameters())
        print(f"Model params: {n / 1e6:.2f} M (pretrained init)", flush=True)
        return self._fresh_state()

    def state_from_tree(self, tree) -> TrainState:
        """A state from a checkpoint tree, or a JAX ``TrainState`` with
        numpy leaves (``convert.train_state_tree``): params into the
        model, moments, count, EMA and step as they are."""
        tree = train_state_tree(tree)
        load_jax_params(self.model, tree["params"])

        def tensors(t):
            return {n: torch.from_numpy(a).to(self.device)
                    for n, a in jax_tree_to_named(self.model, t).items()}
        ema = tree.get("ema_params")
        return TrainState(
            step=int(tree["step"]), params=self._params(),
            opt_state=AdamState(count=int(tree["count"]),
                                mu=tensors(tree["mu"]),
                                nu=tensors(tree["nu"])),
            ema_params=tensors(ema) if ema is not None else None)

    def state_tree(self, state: TrainState) -> Dict:
        """``state`` in the checkpoint format (numpy, flax naming)."""
        return {"step": state.step, "params": export_tensors(state.params),
                "mu": export_tensors(state.opt_state.mu),
                "nu": export_tensors(state.opt_state.nu),
                "count": state.opt_state.count,
                "ema_params": (export_tensors(state.ema_params)
                               if state.ema_params is not None else None)}

    # ---------------- checkpointing ----------------
    def save(self, state: TrainState) -> Path:
        return write_checkpoint(self.ckpt_dir, self.state_tree(state))

    def restore(self) -> Optional[TrainState]:
        """Auto-resume from the newest checkpoint if there is one
        (reference experiment.py:464-473)."""
        if not checkpoint_steps(self.ckpt_dir):
            return None
        return self.state_from_tree(read_checkpoint(self.ckpt_dir))

    # ---------------- the step ----------------
    def shape_batch(self, b: dict) -> dict:
        """Split the loader's (effective) batch into ``accum`` microbatches
        on the device; clamp so a batch smaller than ``accum_batches``
        still trains (one sample a microbatch), and warn about a tail that
        does not tile (the reference asserts divisibility instead,
        experiment.py:98-105)."""
        img, rna = b["image"], b["rna"]
        n = img.shape[0]
        a = max(1, min(self.conf.accum_batches, n))
        micro = n // a
        if a * micro < n:
            warnings.warn(
                f"train batch of {n} samples does not tile accum({a}); "
                f"dropping {n - a * micro} sample(s) this step — size the "
                "loader batch to a multiple of accum", stacklevel=2)
        return {k: torch.as_tensor(np.ascontiguousarray(
                    v[:a * micro].reshape(a, micro, *v.shape[1:])))
                .to(self.device)
                for k, v in (("image", img), ("rna", rna))}

    def draw(self, image: torch.Tensor) -> tuple:
        """(t, noise, block origin) of one microbatch of padded images
        ``image`` (B, H+ps, W+ps, C), from the trainer's generators."""
        ps = self.conf.image_size
        b, hp, wp, _ = image.shape
        t = torch.randint(0, self.sampler.schedule.num_timesteps, (b,),
                          generator=self.gen, device=self.device)
        noise = torch.randn(image.shape, generator=self.gen,
                            device=self.device)
        ix, iy = (int(torch.randint(0, n, (), generator=self.host_gen))
                  for n in (hp // ps - 1, wp // ps - 1))
        return t, noise, (ix, iy)

    def loss(self, image: torch.Tensor, rna: torch.Tensor,
             draw: Optional[tuple] = None) -> torch.Tensor:
        """The dual-decoder loss of one microbatch of unpadded (possibly
        uint8) images, with the draws given or drawn."""
        half = self.conf.image_size // 2
        image, rna = decode_batch(image, rna)
        x_pad = F.pad(image, (0, 0, half, half, half, half))
        t, noise, block = draw if draw is not None else self.draw(x_pad)
        gen = self.gen if self.conf.dropout > 0 else None
        model = self.model

        def apply(xp, tm, rp, gen_state=None):
            if gen_state is not None:   # the recompute draws the same masks
                gen.set_state(gen_state)
            return model(xp, tm, rp, 2, 2, generator=gen)

        def model_fn(xp, tm, rp, p1, p2):
            if (p1, p2) != (2, 2):
                raise ValueError(f"training crops 2x2 blocks, not {p1}x{p2}")
            if not self.conf.remat:
                return apply(xp, tm, rp)
            return torch.utils.checkpoint.checkpoint(
                apply, xp, tm, rp,
                gen.get_state() if gen is not None else None,
                use_reentrant=False)

        return self.sampler.training_loss(model_fn, x_pad, rna, t,
                                          noise=noise, block_idx=block)

    def loss_and_grads(self, batch: dict,
                       draws: Optional[Sequence[tuple]] = None):
        """(mean loss, mean gradient by parameter name) over the
        microbatches of a ``shape_batch`` batch; ``draws``: one
        (t, noise, block origin) a microbatch, else drawn.  Leaves the
        parameters' ``.grad`` empty."""
        params = self._params()
        for p in params.values():
            p.grad = None
        n_acc = batch["image"].shape[0]
        total = None
        for a in range(n_acc):
            loss = self.loss(batch["image"][a], batch["rna"][a],
                             draws[a] if draws is not None else None)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        names = list(params)
        grads = torch._foreach_div(
            [params[n].grad if params[n].grad is not None
             else torch.zeros_like(params[n]) for n in names], n_acc)
        for p in params.values():
            p.grad = None
        return total / n_acc, dict(zip(names, grads))

    def train_step(self, state: TrainState, batch: dict,
                   draws: Optional[Sequence[tuple]] = None):
        """One optimizer step on a ``shape_batch`` batch: (new state,
        mean loss as a 0-d device tensor).  Updates ``state`` in place."""
        loss, grads = self.loss_and_grads(batch, draws)
        state.opt_state = self.optimizer.step(state.params, grads,
                                              state.opt_state)
        state.step += 1
        if self.ema and state.ema_params is not None:
            d = self.conf.ema_decay     # e = e d + p (1 - d)
            with torch.no_grad():
                names = list(state.ema_params)
                ema = [state.ema_params[n] for n in names]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(
                    [state.params[n] for n in names], 1 - d))
        return state, loss

    # ---------------- in-training sampling preview ----------------
    @torch.no_grad()
    def preview(self, state: TrainState, batch: dict, out_dir: str,
                step: int) -> str:
        """Periodic DDIM sample grid on the batch's gene maps (reference
        log_sample/gen_sample, experiment.py:293-392): the full crop
        generated with the eval sampler, one row a sample, per z-channel a
        [blank|PolyT|DAPI] composite, generated|real side by side."""
        from PIL import Image

        conf = self.conf
        img, rna = decode_batch(
            torch.as_tensor(batch["image"][:conf.sample_size]).to(self.device),
            torch.as_tensor(batch["rna"][:conf.sample_size]).to(self.device))
        rna_pat = patchify(rna, conf.gn_sz)   # covers (H+ps, W+ps)
        noise = torch.randn(img.shape, device=self.device, generator=(
            torch.Generator(self.device).manual_seed(step)))
        use_ema = self.ema and state.ema_params is not None
        saved = ({n: p.detach().clone() for n, p in state.params.items()}
                 if use_ema else None)
        self.model.eval()
        try:
            if use_ema:
                for n, p in state.params.items():
                    p.copy_(state.ema_params[n])
            gen = self.eval_sampler.sample(
                lambda xp, tm, rp, p1, p2: self.model(
                    xp, tm, rp, p1, p2, decode_original=False),
                noise, rna_pat)
        finally:
            self.model.train()
            if use_ema:
                for n, p in state.params.items():
                    p.copy_(saved[n])

        arr = torch.clamp((torch.stack([gen, img]) + 1) * 127.5, 0, 255
                          ).cpu().numpy().astype(np.uint8)  # (2,b,H,W,C)
        stains = 2 if conf.stain == "all" else 1
        zi = arr.shape[-1] // stains

        def rgb(panel, z):  # (H, W, C) -> (H, W, 3), channels stain-major
            if stains == 2:
                return np.stack([np.zeros_like(panel[..., 0]),
                                 panel[..., zi + z], panel[..., z]], -1)
            g = panel[..., z]
            return np.stack([g, g, g], -1)

        rows = [np.concatenate([rgb(arr[k, i], z) for z in range(zi)
                                for k in (0, 1)], axis=1)
                for i in range(arr.shape[1])]
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{step}_DDIM.jpg"
        Image.fromarray(np.concatenate(rows, axis=0)).save(path)
        return str(path)

    # ---------------- the loop ----------------
    def fit(self, batch_iter: Iterator[dict], *, max_steps: int,
            log_every: int = 50, state: Optional[TrainState] = None,
            sample_dir: Optional[str] = None,
            metrics: bool = True) -> TrainState:
        """Train until ``state.step`` reaches ``max_steps`` (auto-resuming
        from the newest checkpoint when no ``state`` is given), logging
        the loss, samples/s and the share of wall time spent waiting for
        data (next batch + decode + host-to-device copy), and leaving a
        checkpoint behind."""
        conf = self.conf
        writer = None
        if metrics:
            from .tb import MetricWriter
            writer = MetricWriter(conf.logdir)
        Path(conf.logdir).mkdir(parents=True, exist_ok=True)
        conf.save(Path(conf.logdir) / "config.json")
        first = next(batch_iter)
        if state is None:
            state = self.restore()
            if state is not None:
                print(f"resumed from step {state.step}", flush=True)
            else:
                state = self.init_state()

        losses, t0 = [], time.time()
        t_data = t_step = 0.0
        it = itertools.chain([first], batch_iter)
        try:
            while state.step < max_steps:
                td = time.time()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                dev_batch = self.shape_batch(batch)
                data_s = time.time() - td
                ts = time.time()
                state, loss = self.train_step(state, dev_batch)
                lv = float(loss)            # waits for the device step
                step_s = time.time() - ts
                t_data += data_s
                t_step += step_s
                losses.append(lv)
                self.log.append(dict(step=state.step, loss=lv,
                                     data_s=data_s, step_s=step_s))
                step = state.step
                if step % log_every == 0 or step == 1:
                    mean = float(np.mean(losses))
                    dt = time.time() - t0
                    rate = conf.batch_size_effective * len(losses) / max(
                        dt, 1e-9)
                    dpct = 100.0 * t_data / max(t_data + t_step, 1e-9)
                    print(f"step {step}  loss {mean:.5f}  ({dt:.1f}s, "
                          f"{rate:.1f} samples/s, data-wait {dpct:.0f}%)",
                          flush=True)
                    if writer is not None:
                        writer.scalar("loss", mean, step)
                        writer.scalar("samples_per_sec", rate, step)
                        writer.scalar("data_wait_pct", dpct, step)
                    losses, t0 = [], time.time()
                    t_data = t_step = 0.0
                if step % conf.save_every_steps == 0:
                    self.save(state)
                if sample_dir and (step == 1
                                   or step % conf.sample_every_steps == 0):
                    p = self.preview(state, batch, sample_dir, step)
                    print(f"sample grid -> {p}", flush=True)
                    if writer is not None:
                        from PIL import Image
                        writer.image("sample", np.asarray(Image.open(p)),
                                     step)
            # always leave a resumable checkpoint behind (reference
            # ModelCheckpoint(save_last=True))
            if state.step % conf.save_every_steps != 0:
                self.save(state)
        finally:
            if writer is not None:
                writer.close()
        return state

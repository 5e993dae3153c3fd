"""Tera-scale generation CLI on one device: in memory, or host-streamed.

    python -m tera_mind_tpu_torch.cli.generate --mouse 638850 \
        --ckpt_pth checkpoints/638850_64_229_all_4_ours/last.ckpt \
        --data_path Data/MERFISH_50/gene_638850 \
        --hst 38400 --wst 38400 --hnm 4 --wnm 4 --out_dir out/roi

    python -m tera_mind_tpu_torch.cli.generate --synthetic --hnm 2 --wnm 2

    python -m tera_mind_tpu_torch.cli.generate --synthetic --stream \
        --hnm 4 --wnm 4

    python -m tera_mind_tpu_torch.cli.generate --synthetic --quant int8

Port of ``tera_mind_tpu/cli/generate.py`` for one device: the z-packed
``PackedTeraUNet`` by default (``--no_packed``: the 5D ``TeraUNet``,
``--packed_attn``: DiT blocks on the packed tokens), in bf16, DDIM steps
(eta 0), block-major by default (``--tile_major``: per-tile windows),
per-tile LCG noise drawn on the CPU.  ``--window_chunk -1`` (the default)
plans the in-memory step's memory (``TeraGenerator.auto_plan``); with
``--stream`` the state stays on the host and windows of
``--stream_block``^2 tiles stream through the card
(``parallel/streaming.py``).  Weights come
from a reference Lightning ``.ckpt`` (the preset is read from its run
directory's name) or, without one, from a seeded random init.  Gene tiles
come from the reference's per-tile COO files under ``--data_path`` or,
with ``--synthetic``, from one seeded field.  The state is spilled to
``{out_dir}_state_{epoch}`` every ``--ckpt_every`` steps; a rerun resumes
from the latest spill, or from ``--cur_epoch``'s.  The final tiles are
written to ``--out_dir`` as float16 ``.npy`` files named
``{h0}_{h1}_{w0}_{w1}``, with per-slice jpg previews under
``{out_dir}/preview`` for grids of up to 32x32 tiles.  ``--ckpt_pth`` is
a reference ``.ckpt`` or the port trainer's checkpoint directory
(``{logdir}/ckpt``, its newest step, EMA params when it has them); the
``config.json`` beside either is preferred over the run directory's
name.  ``--quant int8`` runs the packed model's ResBlock convs (and,
unless ``--no_quant_attn``, its DiT denses) in int8 with weights
quantized once (``ops/quant.py``: K4 and K3 on the card); ``--quant
int8_static`` first calibrates static activation scales on one dynamic
chain over the grid's first (up to) 2x2 block, then swaps in the static
model.  JAX ignores ``--quant`` with ``--no_packed``; the port refuses
that combination.  Not ported yet: the JAX trainer's orbax directories
and multi-process runs (``--coordinator``, ``--num_processes``,
``--process_id``).
"""

from __future__ import annotations

import argparse
import functools
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import TrainConfig, config_from_name, prep_config
from ..convert import (convert_unet_params, export_params, load_jax_params,
                       load_torch_state_dict)
from ..data.coo import COO
from ..data.tilestore import StateCheckpoint, TileStore, tile_name
from ..models.nn import channels_last_, init_weights
from ..models.unet import TeraUNetConfig
from ..models.unet_packed import make_packed_model, pack_unet_params
from ..ops.quant import calibrate_generator, prequantize_params
from ..parallel.generator import GeneratorConfig, TeraGenerator, grid_to_image
from ..parallel.streaming import StreamConfig, StreamingGenerator
from ..training.harness import read_checkpoint

TILE = 256          # px per tile side, the reference's grid unit


def load_gene_tile(path: Path, *, gblk: int, gdim: int, spad: int,
                   tile: int = TILE, overlap: int = 128, pad: int = 32
                   ) -> np.ndarray:
    """One inference gene file -> (gsz, gsz, z_pad, G) dense stack.

    A file covers the tile and ``overlap`` px around it (named as the
    reference's gn_sublst, test_brn.py:51-70); bins are summed over
    ``gblk`` px and cropped to the half-patch-padded tile, and the z
    channels are zero-padded by ``spad`` slices on each side (reference
    MBADataset_tst.py:65-89)."""
    gn = COO.load_npz(path).block_sum(gblk)
    if spad > 0:
        gn = gn.pad_channels(spad * gdim, spad * gdim)
    off = (overlap - pad) // gblk
    gsz = (tile + 2 * pad) // gblk
    dense = gn.crop2d(off, off, gsz, gsz).todense(np.float32)
    return dense.reshape(gsz, gsz, dense.shape[-1] // gdim, gdim)


def gene_tile_name(h0: int, w0: int, tile: int = TILE,
                   overlap: int = 128) -> str:
    """The reference's gene file of the tile at pixel (h0, w0)."""
    return (f"{h0}_{h0 + tile}_{w0}_{w0 + tile}_{h0 - overlap}_"
            f"{h0 + tile + overlap}_{w0 - overlap}_{w0 + tile + overlap}.npz")


def gene_provider(gdir: Path, hst: int, wst: int, *, gdim: int,
                  spad: int) -> Callable[[int, int], np.ndarray]:
    """``(r, c) -> (gsz, gsz, z_pad, G)``: the gene stack of the grid's
    tile (r, c), whose top-left pixel is (hst + r*256, wst + c*256)."""
    def gene(r: int, c: int) -> np.ndarray:
        name = gene_tile_name(hst + r * TILE, wst + c * TILE)
        return load_gene_tile(gdir / name, gblk=16, gdim=gdim, spad=spad)
    return gene


def synthetic_gene_grid(rows, cols, gsz, z_pad, gdim, seed=0,
                        overlap_bins=4):
    """Per-tile padded gene arrays sliced from ONE global field, so
    neighbouring tiles' overlap bins agree (what real data has and the
    block-major bin assembly relies on)."""
    nb = gsz - overlap_bins          # bins owned per tile side
    hb = overlap_bins // 2
    rng = np.random.default_rng(seed)
    fshape = (rows * nb + 2 * hb, cols * nb + 2 * hb, z_pad, gdim)
    field = ((rng.random(fshape) < 0.01) *
             rng.integers(1, 5, fshape)).astype(np.uint8)
    return np.stack([
        np.stack([field[r * nb: r * nb + gsz, c * nb: c * nb + gsz]
                  for c in range(cols)]) for r in range(rows)])


def save_preview(out: np.ndarray, odir: Path, stain: str, stains: int,
                 n_win: int, zi: int, max_px: int = 8192) -> None:
    """One 8-bit jpg per z-slice and stain of the final (H, W, channels)
    state, channels stain-major (reference gen_img, test_brn.py:73-121);
    nothing for a state wider than ``max_px``."""
    from PIL import Image
    odir.mkdir(parents=True, exist_ok=True)
    h, w, _ = out.shape
    if h > max_px or w > max_px:
        return
    img8 = np.clip((out + 1) * 127.5, 0, 255).astype(np.uint8)
    names = ["DAPI", "PolyT"] if stains == 2 else [stain]
    for s, nm in enumerate(names):
        for sl in range(n_win * zi):
            Image.fromarray(img8[..., s * n_win * zi + sl]).save(
                odir / f"{sl}_{nm}_gen.jpg")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Tera-scale generation "
                                 "(PyTorch port)")
    ap.add_argument("--mouse", type=str, default="638850")
    ap.add_argument("--data_path", "-d", type=str, default="",
                    help="directory of the per-tile gene .npz files "
                    "(default Data/MERFISH_50/gene_{mouse})")
    ap.add_argument("--ckpt_pth", type=Path, default=None,
                    help="reference Lightning .ckpt, or the port trainer's "
                    "checkpoint directory ({logdir}/ckpt); the config.json "
                    "beside it, else its directory's name, gives the "
                    "preset (reference test_brn.py:337-344)")
    ap.add_argument("--out_dir", "-g", type=str, default="./output_tiles")
    ap.add_argument("--hst", type=int, default=256)
    ap.add_argument("--wst", type=int, default=256)
    ap.add_argument("--hnm", type=int, default=286)
    ap.add_argument("--wnm", type=int, default=414)
    ap.add_argument("--tot_epoch", type=int, default=15)
    ap.add_argument("--cur_epoch", type=int, default=None,
                    help="resume from this epoch's spill; default: the "
                    "latest spill, if any")
    ap.add_argument("--ckpt_every", type=int, default=5,
                    help="spill the state every this many steps (0: never)")
    ap.add_argument("--synthetic", action="store_true",
                    help="a seeded synthetic gene grid instead of gene files")
    ap.add_argument("--stream", action="store_true",
                    help="host-resident state, block-streamed through the "
                    "device (grids larger than its memory; "
                    "parallel/streaming.py)")
    ap.add_argument("--stream_block", type=int, default=2,
                    help="tiles per streamed device window (per side)")
    ap.add_argument("--stream_k", type=int, default=1,
                    help="temporal halo blocking: DDIM steps per window "
                    "visit (exact; cuts the host<->device state traffic "
                    "~K-fold at the cost of an enlarged window halo; "
                    "max tile//patch + 1)")
    ap.add_argument("--stream_memmap", type=str, default=None,
                    help="disk-back the host state (beyond-RAM grids)")
    ap.add_argument("--stream_inflight", type=int, default=3,
                    help="streaming windows in flight (worker threads, each "
                    "with its own CUDA stream: assembly and transfers "
                    "overlap compute; results identical, see "
                    "StreamConfig.inflight)")
    ap.add_argument("--stream_gene_gb", type=float, default=4.0,
                    help="device budget (GB) for pinning the timestep-"
                    "invariant gene blocks on the card across sweeps "
                    "(0 disables; bit-identical either way)")
    ap.add_argument("--stream_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="host<->device state transfer dtype; bfloat16 "
                    "halves the state's round trip (the reference "
                    "round-trips fp16 state through disk every step). "
                    "The host state buffers are stored in this dtype too "
                    "(bit-identical, halves host RAM/memmap bytes and "
                    "makes window staging a memcpy); --stream_state_dtype "
                    "overrides")
    ap.add_argument("--stream_state_dtype", default=None,
                    choices=(None, "float32", "bfloat16"),
                    help="override the HOST state buffer dtype (default: "
                    "same as --stream_dtype)")
    ap.add_argument("--window_chunk", type=int, default=-1,
                    help="z-windows per model call (activation-memory "
                    "bound; 0 = all 25). Default -1 = AUTO: the in-memory "
                    "generator plans (strip_rows, window_chunk) from the "
                    "grid size and a measured probe of the card's memory; "
                    "--stream resolves it per block size (5 at the "
                    "default 2x2 block); --tile_major takes 5")
    ap.add_argument("--tile_major", action="store_true",
                    help="per-tile window processing (the reference's "
                    "layout); default is block-major: one patch grid over "
                    "the block, ~36%% fewer patches at scale, the same "
                    "result")
    ap.add_argument("--quant", default="",
                    choices=("", "int8", "int8_static"),
                    help="int8: the ResBlock convs in int8 (ops/quant.py: "
                    "the K4 quantize and K3 int8 conv kernels on the card; "
                    "quality bound in tests/test_torch_quant.py; requires "
                    "the packed model). int8_static additionally "
                    "calibrates static activation scales on the grid's "
                    "first block, quality gated by the same tests")
    ap.add_argument("--no_quant_attn", action="store_true",
                    help="with --quant: keep the DiT blocks' dense "
                    "projections (adaLN/qkv/proj/MLP) in bf16 instead of "
                    "int8 (ops/quant.py QuantDense)")
    ap.add_argument("--no_packed", action="store_true",
                    help="run the 5D TeraUNet instead of its z-packed "
                    "re-parameterization (models/unet_packed.py)")
    ap.add_argument("--packed_attn", action="store_true",
                    help="run the DiT blocks on the packed (h, w, z) tokens "
                    "(no unpack/pack around each block; equal up to float "
                    "reassociation)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", type=str, default=None,
                    help="also save the final (H, W, channels) state here "
                    "as .npy")
    return ap.parse_args(argv)


def make_model(mconf: TeraUNetConfig, params5: Optional[dict] = None, *,
               seed: int = 0, packed: bool = True, packed_attn: bool = False,
               quant: str = "", quant_attn: bool = True) -> torch.nn.Module:
    """The model in the compute dtype on the CPU, from a 5D flax-named
    tree ``params5`` or, without one, from ``init_weights(seed)`` of the
    5D model.  ``packed``: the tree is packed (``pack_unet_params``) into
    a ``PackedTeraUNet``, as the JAX CLI does; with ``quant`` (``int8``,
    ``int8_static``) it is also pre-quantized (``prequantize_params``,
    the DiT denses too with ``quant_attn``) into the DYNAMIC prequantized
    int8 model: ``int8_static`` calibrates from there
    (:func:`calibrate_static`)."""
    if params5 is None:
        model5 = init_weights(mconf.make_model(), seed)
        if not packed:
            return model5
        params5 = export_params(model5)
    if not packed:
        return load_jax_params(mconf.make_model(), params5)
    tree = pack_unet_params(params5, mconf)
    if not quant:
        return load_jax_params(
            make_packed_model(mconf, packed_attn=packed_attn), tree)
    return load_jax_params(quant_model(mconf, packed_attn, quant_attn),
                           prequantize_params(tree, attn=quant_attn))


def quant_model(mconf: TeraUNetConfig, packed_attn: bool, quant_attn: bool,
                static_act: bool = False) -> torch.nn.Module:
    """The prequantized int8 ``PackedTeraUNet`` (dynamic activations, or
    ``static_act``), in the compute dtype with float32 scales."""
    return make_packed_model(mconf, packed_attn=packed_attn, quant="int8",
                             prequant=True, quant_attn=quant_attn,
                             static_act=static_act)


def calibrate_static(args: argparse.Namespace, gen: TeraGenerator,
                     model: torch.nn.Module, gene, origin: tuple,
                     model_fn: Callable) -> tuple:
    """``--quant int8_static``: one dynamic int8 chain of ``model`` over
    the grid's first min(2, rows) x min(2, cols) block with the
    activation abs-maxes recorded (``calibrate_generator``), then the
    static model with the baked scales, on ``model``'s device.  Returns
    (generator, static model); ``model_fn(m)`` makes a generator's model
    function of a model."""
    crows, ccols = min(2, args.hnm), min(2, args.wnm)
    if callable(gene):
        cgene = np.stack([np.stack([gene(r, c) for c in range(ccols)])
                          for r in range(crows)])
    else:
        cgene = gene[:crows, :ccols]
    t0 = time.perf_counter()
    cgen = TeraGenerator(gen.sampler, model_fn(model), gen.conf,
                         device=gen.device)
    tree = calibrate_generator(cgen, model, export_params(model), cgene,
                               steps=args.tot_epoch, row0=origin[0],
                               col0=origin[1])
    static = quant_model(model.conf, args.packed_attn,
                         not args.no_quant_attn, static_act=True)
    static = channels_last_(load_jax_params(static, tree).to(
        gen.device)).eval()
    print(f"calibrated int8 static activation scales on a {crows}x{ccols} "
          f"block in {time.perf_counter() - t0:.2f} s", flush=True)
    return (TeraGenerator(gen.sampler, model_fn(static), gen.conf,
                          device=gen.device), static)


def run_config(args: argparse.Namespace):
    """The run's ``TrainConfig`` in bf16: the ``config.json`` beside the
    checkpoint (what the trainer persisted, exact for fields the run name
    does not encode, such as ``net_ch``), else the preset of the
    checkpoint's run directory name, or of ``--mouse``."""
    if args.ckpt_pth is not None:
        if args.ckpt_pth.suffix != ".ckpt" and not args.ckpt_pth.is_dir():
            raise SystemExit(f"--ckpt_pth {args.ckpt_pth}: not a reference "
                             ".ckpt file or a port checkpoint directory")
        cj = args.ckpt_pth.parent / "config.json"
        conf = (TrainConfig.load(cj) if cj.exists()
                else config_from_name(args.ckpt_pth.parent.name))
    else:
        conf = prep_config(args.mouse)
    conf.compute_dtype = "bfloat16"
    return conf


def build(args: argparse.Namespace):
    """(generator, model, gene grid or provider, grid origin) for
    ``args``, the model on the device."""
    if args.quant and args.no_packed:
        raise SystemExit("--quant requires the packed model: drop "
                         "--no_packed")
    device = torch.device(args.device)
    conf = run_config(args)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass "
                         "--device cpu")
    mconf = conf.make_model_conf()
    params5 = None
    if args.ckpt_pth is not None and args.ckpt_pth.suffix == ".ckpt":
        params5 = convert_unet_params(load_torch_state_dict(args.ckpt_pth),
                                      mconf)
        print(f"converted torch checkpoint {args.ckpt_pth}", flush=True)
    elif args.ckpt_pth is not None:
        tree = read_checkpoint(args.ckpt_pth)
        params5 = tree["ema_params"] or tree["params"]
        print(f"restored port checkpoint step {tree['step']}"
              f"{' (ema)' if tree['ema_params'] else ''}", flush=True)
    else:
        print("WARNING: random init (no checkpoint)", flush=True)
    model = make_model(mconf, params5, seed=conf.seed,
                       packed=not args.no_packed,
                       packed_attn=args.packed_attn, quant=args.quant,
                       quant_attn=not args.no_quant_attn)
    model = channels_last_(model.to(device)).eval()

    gconf = GeneratorConfig(tile=TILE, patch=conf.image_size, gn_blk=16,
                            snum=conf.rna_slices, n_slices=50,
                            stains=2 if conf.stain == "all" else 1,
                            gdim=500,
                            window_chunk=(5 if args.tile_major
                                          and args.window_chunk < 0
                                          else args.window_chunk))

    def model_fn(m):
        # sampling reads only the collage decode
        return lambda xp, tm, rp, p1, p2: m(xp, tm, rp, p1, p2,
                                            decode_original=False)

    sampler = conf.make_eval_sampler(T=args.tot_epoch)
    gen = TeraGenerator(sampler, model_fn(model), gconf, device=device)
    if args.synthetic:
        gene = synthetic_gene_grid(args.hnm, args.wnm, gconf.gsz,
                                   gconf.z_pad, gconf.gdim)
    else:
        gdir = Path(args.data_path or f"Data/MERFISH_50/gene_{args.mouse}")
        gene = functools.lru_cache(maxsize=4 * (args.stream_block + 2) ** 2)(
            gene_provider(gdir, args.hst, args.wst, gdim=gconf.gdim,
                          spad=gconf.spad))
    origin = (args.hst // TILE, args.wst // TILE)
    if args.quant == "int8_static":
        gen, model = calibrate_static(args, gen, model, gene, origin,
                                      model_fn)
    return gen, model, gene, origin


def make_streamer(args: argparse.Namespace,
                  gen: TeraGenerator) -> StreamingGenerator:
    """The ``--stream*`` options' streaming generator around ``gen``."""
    return StreamingGenerator(gen, StreamConfig(
        block_rows=args.stream_block, block_cols=args.stream_block,
        checkpoint_every=args.ckpt_every, memmap_dir=args.stream_memmap,
        block_major=not args.tile_major, steps_per_window=args.stream_k,
        inflight=args.stream_inflight,
        gene_device_cache_gb=args.stream_gene_gb,
        transfer_dtype=args.stream_dtype,
        state_dtype=args.stream_state_dtype))


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    gen, _, gene, (row0, col0) = build(args)
    c = gen.conf
    rows, cols = args.hnm, args.wnm
    ck = StateCheckpoint(f"{args.out_dir}_state", fmt="grid")
    state0 = start_t = None
    if args.cur_epoch is not None:
        grid, meta = ck.load_grid(args.cur_epoch)
        got = (meta["rows"], meta["cols"], meta["size"], meta["channels"])
        if got != (rows, cols, c.tile, c.channels):
            raise SystemExit(f"spill of epoch {args.cur_epoch} holds (rows, "
                             f"cols, size, channels) {got}, not "
                             f"{(rows, cols, c.tile, c.channels)}")
        state0 = grid_to_image(grid)
        start_t = args.tot_epoch - args.cur_epoch

    t0 = time.perf_counter()
    if args.stream:
        sgen = make_streamer(args, gen)
        hstate = None
        if state0 is not None:
            hstate = sgen.make_state(rows, cols)
            hstate.read[:] = torch.from_numpy(state0)
        hstate = sgen.run(rows, cols, gene, row0=row0, col0=col0,
                          grid_w=416, checkpoint=ck, state=hstate,
                          start_t=start_t)
        out = hstate.read.float().numpy()
    else:
        out = gen.run(gene, rows=rows, cols=cols, row0=row0, col0=col0,
                      grid_w=416, state=state0, start_t=start_t,
                      checkpoint=ck, checkpoint_every=args.ckpt_every,
                      block_major=not args.tile_major)
    dt = time.perf_counter() - t0

    store = TileStore(args.out_dir).create()
    size = c.tile
    for r in range(rows):
        for cc in range(cols):
            h0, w0 = args.hst + r * size, args.wst + cc * size
            store.write(tile_name(h0, h0 + size, w0, w0 + size),
                        out[r * size:(r + 1) * size,
                            cc * size:(cc + 1) * size].astype(np.float16))
    if rows <= 32 and cols <= 32:
        save_preview(out, Path(args.out_dir) / "preview",
                     run_config(args).stain, c.stains, c.n_win, c.zi)
    if args.out:
        np.save(args.out, out)
    print(f"done: {rows}x{cols} tiles, {args.tot_epoch} steps in {dt:.2f} s;"
          f" state {out.shape} in [{out.min():.3f}, {out.max():.3f}] -> "
          f"{args.out_dir}", flush=True)
    return out


if __name__ == "__main__":
    main()

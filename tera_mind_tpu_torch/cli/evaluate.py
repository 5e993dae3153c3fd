"""Evaluation CLI: generated tile store vs reference tiles.

    python -m tera_mind_tpu_torch.cli.evaluate --gen_dir out/roi \
        --real_dir data/tiles --report out/eval.json

Port of ``tera_mind_tpu/cli/evaluate.py`` (capability parity with the
reference's offline eval scripts, utils/metrics.py + utils/feat_mba.py):
intensity statistics of the generated tiles and, with ``--real_dir``,
d-FID over the paired tiles (streaming moments) and PSNR / SSIM / MS-SSIM
(MS-SSIM only for tiles of at least 160 px a side), with the JSON keys of
the JAX CLI.  ``--features`` picks the network: ``inception`` (the port's
InceptionV3 on a torchscript export's weights), ``torchscript`` (the
export itself), ``clip`` (transformers' CLIP from a local directory) or
``pool`` (weight-free pooled statistics, reported as ``pool_fid``, not
comparable to the paper's d-FID).  A network needs its local weights in
``--feature_weights``: nothing is downloaded, and there is no silent fall
back to pool features.  Features and the image metrics run on
``--device`` (``cuda`` by default, ``cpu`` on request); without a card
the CLI exits.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.tilestore import TileStore
from ..metrics.features import (CLIPFeatures, PoolFeatures,
                                TorchscriptFeatures, d_fid_between_stores)
from ..metrics.inception import InceptionFeatures
from ..metrics.ssim import ms_ssim, psnr, ssim
from ..metrics.stats import OnlineVariance


def _tile_slices(store, names, channel: int):
    for n in names:
        a = np.asarray(store.read(n), np.float32)
        yield a[..., channel] if a.ndim == 3 else a


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="evaluate generated tiles "
                                 "(PyTorch port)")
    ap.add_argument("--gen_dir", required=True)
    ap.add_argument("--real_dir", default=None,
                    help="paired real tiles (same names); omit for "
                    "gen-only stats")
    ap.add_argument("--channel", type=int, default=0,
                    help="channel (slice*stain) index to evaluate")
    ap.add_argument("--report", default=None, help="write JSON report here")
    ap.add_argument("--features", default="pool",
                    choices=("pool", "torchscript", "inception", "clip"))
    ap.add_argument("--feature_weights", default=None,
                    help="weights path: torchscript InceptionV3 export "
                    "(torchscript/inception; reference feat_mba.py:29-42) "
                    "or a local CLIP model dir (clip)")
    ap.add_argument("--max_tiles", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def make_extractor(args: argparse.Namespace, device: torch.device):
    """(extractor, report key) of ``--features``."""
    if args.features != "pool" and not args.feature_weights:
        raise SystemExit(f"--features {args.features} requires "
                         "--feature_weights (refusing to silently fall back "
                         "to pool features)")
    if args.features == "torchscript":
        return TorchscriptFeatures(args.feature_weights, device=device), \
            "d_fid"
    if args.features == "inception":
        return InceptionFeatures(args.feature_weights, device=device), "d_fid"
    if args.features == "clip":
        return CLIPFeatures(args.feature_weights, device=device), \
            "d_fid_clip"
    return PoolFeatures(), "pool_fid"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass "
                         "--device cpu")

    gen = TileStore(args.gen_dir)
    names = gen.names()
    if args.max_tiles:
        names = names[: args.max_tiles]
    assert names, f"no tiles under {args.gen_dir}"
    report: dict = {"gen_dir": args.gen_dir, "n_tiles": len(names)}

    # intensity stats (always)
    ov = OnlineVariance(1)
    for a in _tile_slices(gen, names, args.channel):
        ov.update(a.reshape(-1, 1))
    report["gen_mean"] = float(ov.mean[0])
    report["gen_std"] = float(ov.std[0])

    if args.real_dir:
        real = TileStore(args.real_dir)
        rnames = [n for n in names if real.has(n)]
        report["n_paired"] = len(rnames)

        # a `d_fid` entry appears ONLY with a real feature network; the
        # weight-free fallback is reported as `pool_fid`
        extractor, key = make_extractor(args, device)
        report[key] = float(d_fid_between_stores(
            _tile_slices(gen, rnames, args.channel),
            _tile_slices(real, rnames, args.channel), extractor))
        if key == "pool_fid":
            report["pool_fid_note"] = ("weight-free pooled features — not "
                                       "comparable to Inception/CLIP d-FID")

        # paired PSNR/SSIM/MS-SSIM (reference metrics.py:201-541)
        ps, ss, ms = [], [], []
        for n in rnames:
            g = np.asarray(gen.read(n), np.float32)
            r = np.asarray(real.read(n), np.float32)
            if g.ndim == 3:
                ch = min(args.channel, g.shape[-1] - 1)
                g, r = g[..., ch], r[..., ch]
            # the metrics take (B, H, W, C)
            g = torch.from_numpy(g[None, ..., None]).to(device)
            r = torch.from_numpy(r[None, ..., None]).to(device)
            ps.append(float(psnr(g, r, 2.0).mean()))
            ss.append(float(ssim(g, r, data_range=2.0).mean()))
            if min(g.shape[1:3]) >= 160:
                ms.append(float(ms_ssim(g, r, data_range=2.0).mean()))
        report["psnr"] = float(np.mean(ps))
        report["ssim"] = float(np.mean(ss))
        if ms:
            report["ms_ssim"] = float(np.mean(ms))

    print(json.dumps(report, indent=2))
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()

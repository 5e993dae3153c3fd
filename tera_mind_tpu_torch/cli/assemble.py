"""WSI assembly CLI (reference infer_brn.py surface).

Stream a generated tile store into per-slice pyramidal OME-BigTIFFs:

    python -m tera_mind_tpu_torch.cli.assemble --gdir out/roi \
        --odir out/wsi --hst 38400 --wst 38400 --hnm 32 --wnm 32

Port of ``tera_mind_tpu/cli/assemble.py``, with its flags and defaults.
A host program: it reads the float16 channels-last tiles that
``cli.generate`` writes (``data/tilestore.py``) and writes one file
``all_{stain}_{slice}.tif`` per channel through the native writer
(``assembly/wsi.py``), one streaming pass per slice with O(row strip)
memory.  The channels are stain-major: with ``--stain all`` the first
half is DAPI, the second PolyT.  ``--preview`` also saves the smallest
pyramid level as a jpg.  No device work, so no ``--device``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="assemble WSIs from tiles")
    ap.add_argument("--gdir", type=str, required=True,
                    help="generated tile store (fp16 channels-last tiles)")
    ap.add_argument("--odir", type=str, required=True)
    ap.add_argument("--hst", type=int, default=256)
    ap.add_argument("--wst", type=int, default=256)
    ap.add_argument("--hnm", type=int, default=286)
    ap.add_argument("--wnm", type=int, default=414)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--slices", type=str, default="all",
                    help="comma-separated slice channels or 'all'")
    ap.add_argument("--stain", type=str, default="all")
    ap.add_argument("--preview", action="store_true",
                    help="also write a jpg from a pyramid level")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list[Path]:
    """Assemble the slices; returns the paths of the files written."""
    args = parse_args(argv)

    from ..assembly.wsi import assemble_slice
    from ..data.tilestore import TileStore, tile_name

    store = TileStore(args.gdir)
    first = store.read(tile_name(args.hst, args.hst + args.size,
                                 args.wst, args.wst + args.size))
    chn = first.shape[-1]
    # channel layout (s, n_win, zi) stain-major -> slice channels per stain
    per_stain = chn // 2 if args.stain == "all" else chn
    stains = ["DAPI", "PolyT"] if args.stain == "all" else [args.stain]
    slices = (list(range(per_stain)) if args.slices == "all"
              else [int(s) for s in args.slices.split(",")])

    odir = Path(args.odir)
    odir.mkdir(parents=True, exist_ok=True)
    written = []
    for si, stain in enumerate(stains):
        for sl in slices:
            ch = si * per_stain + sl

            def read_tile(r, c, _ch=ch):
                h0 = args.hst + r * args.size
                w0 = args.wst + c * args.size
                t = store.read(tile_name(h0, h0 + args.size,
                                         w0, w0 + args.size))
                return t[..., _ch]

            out = odir / f"all_{stain}_{sl}.tif"
            assemble_slice(read_tile, out, args.hnm, args.wnm,
                           tile=args.size)
            written.append(out)
            print(f"wrote {out}", flush=True)
            if args.preview:
                from PIL import Image
                with Image.open(out) as im:
                    im.seek(im.n_frames - 1)
                    im.convert("L").save(out.with_suffix(".jpg"))
    return written


if __name__ == "__main__":
    main()

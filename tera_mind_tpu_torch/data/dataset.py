"""Training data pipeline: MERFISH gene COO + microscopy tiles -> batches.

Replicates the reference sample semantics (utils/MBADataset.py:17-202):
random 256^2 spatial crop, 16px block-sum gene binning, random z-window of
``snum`` slices with zero z-padding, stain selection, joint rot90/flip
augmentation of the dense image and sparse gene coords, [-1,1] image
normalization, and half-bin spatial padding of the gene grid.

Port of ``tera_mind_tpu/data/dataset.py``, numpy only as there: the gene
grid is densified host-side (a 20x20xZ*G dense array per sample is tiny)
and batches are plain numpy arrays, channels-last, copied to the card by
the trainer.  A background thread, or spawned worker processes, pipeline
decoding with the device's steps; either yields the samples in the
order of the dataset's pass.  ``keep`` decodes only some positions of
each batch and skips the rest with the same random draws, which is how a
data-parallel rank loads only its rows of the global batch.  Images are read from ``.npy`` only:
the reference's zarr ``.zip`` and plain zarr directories need
``tensorstore``, which the port's machine does not have, and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..constants import NUM_Z_SLICES
from .coo import COO

# z padding per z-window size: keeps (50 + 2*spad) / (snum/2) - 1 integral
# (reference MBADataset.py:34-36)
SPAD = {None: None, 1: 0, 4: 1, 8: 1, 16: 3}


@dataclasses.dataclass
class Sample:
    image: np.ndarray   # (H, W, S*Zimg) stain-major: float32 in [-1, 1],
                        # or RAW uint8 microscopy when the dataset runs
                        # compact=True (the device normalizes u8/127.5-1,
                        # bit-exact; harness._decode_batch)
    rna: np.ndarray     # (gh+2*pad, gw+2*pad, snum*G) dense float32, or
                        # uint16 counts when compact=True (exact: counts
                        # are integers well below 2^16)


def load_tile_image(path: str | Path):
    """Open a (100, H, W) tile image as a lazily sliceable ``.npy``
    memmap.  The reference's per-tile zarr ``.zip`` and plain zarr
    directories (read through ``tensorstore`` in the JAX package) raise
    ``NotImplementedError``."""
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p, mmap_mode="r")
    raise NotImplementedError(
        f"{p}: zarr images (.zip, .zarr) need the tensorstore package, "
        "which the port does not use; export the tile as .npy")


class MerfishTrainDataset:
    """Iterates training crops from per-tile gene ``.npz`` + image arrays.

    ``gene_paths``: per-tile sparse gene files, pydata-sparse npz layout
    (H, W, 50*G).  The paired image file is derived by the reference's
    convention gene->img, .npz->image array (MBADataset.py:100-101); here
    images are ``.npy`` of shape (100, H, W) channels-first uint8/float
    (50 z * 2 stains, DAPI block then PolyT, matching zarr exports).
    """

    def __init__(self, gene_paths: Sequence[str | Path], *,
                 gdim: int = 500, gblk: int = 16, crop: int = 256,
                 snum: int = 4, stain: str = "all", pad_bins: int = 2,
                 augment: bool = True, repeat: int = 10,
                 seed: int = 0, compact: bool = False):
        """``compact=True``: emit RAW uint8 image crops and uint16 gene
        counts instead of pre-normalized float32 — the device decodes
        them bit-exactly (harness._decode_batch) and the per-batch
        host->device bytes drop ~2.3x (image 4x, rna 2x; the dominant
        cli.train cost on slow links).  Falls back to float32 per sample
        when the image source is not uint8."""
        if snum is None or snum not in SPAD:
            raise ValueError(f"snum {snum} not in (1, 4, 8, 16)")
        if stain not in ("DAPI", "PolyT", "all"):
            raise ValueError(f"stain {stain!r}")
        self.paths = [Path(p) for p in gene_paths] * repeat
        self.gdim, self.gblk, self.crop = gdim, gblk, crop
        self.snum, self.stain, self.pad_bins = snum, stain, pad_bins
        self.spad = SPAD[snum]
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.zmax = NUM_Z_SLICES
        self.compact = compact
        self._hw: dict = {}     # path -> the gene grid's (H, W)

    def __len__(self) -> int:
        return len(self.paths)

    def _image_path(self, gene_path: Path) -> Path:
        """gene -> img naming (reference MBADataset.py:100-101); prefers the
        reference's zarr ``.zip`` when present, else ``.npy``."""
        base = str(gene_path).replace("gene", "img")
        for ext in (".zip", ".zarr", ".npy"):
            p = Path(base.replace(".npz", ext))
            if p.exists():
                return p
        return Path(base.replace(".npz", ".npy"))

    def _draw(self, gh: int, gw: int) -> tuple:
        """One sample's random crop origin, z window start (over the
        z-padded range, MBADataset.py:133-136), rot90 count and flip, drawn
        from ``self.rng`` in the reference's order."""
        rng = self.rng
        top = int(rng.integers(0, gh - self.crop + 1))
        left = int(rng.integers(0, gw - self.crop + 1))
        snm = int(rng.integers(0, self.zmax + 2 * self.spad - self.snum + 1))
        rot, flip = 0, False
        if self.augment:
            rot = int(rng.integers(0, 4))
            flip = rng.random() < 0.5
        return top, left, snm, rot, flip

    def skip(self, idx: int) -> None:
        """Take sample ``idx``'s random draws without decoding it (the
        gene grid's size is read from the file's header once a path)."""
        path = self.paths[idx]
        if path not in self._hw:
            with np.load(path, allow_pickle=False) as f:
                self._hw[path] = tuple(int(v) for v in f["shape"][:2])
        self._draw(*self._hw[path])

    def sample(self, idx: int) -> Sample:
        gene = COO.load_npz(self.paths[idx])
        gh, gw = gene.shape[:2]
        self._hw[self.paths[idx]] = (gh, gw)
        top, left, snm, rot, flip = self._draw(gh, gw)

        gn = gene.crop2d(top, left, self.crop, self.crop)
        gn = gn.block_sum(self.gblk)
        if self.snum > 1:
            gn = gn.pad_channels(self.spad * self.gdim, self.spad * self.gdim)
        gn = gn.slice_channels(snm * self.gdim, (snm + self.snum) * self.gdim)

        img = load_tile_image(self._image_path(self.paths[idx]))
        img = np.asarray(img[:, top:top + self.crop, left:left + self.crop])
        compact = self.compact and img.dtype == np.uint8
        if not compact:
            img = img.astype(np.float32)
        img = img.reshape(2, self.zmax, self.crop, self.crop)
        if self.stain == "DAPI":
            img = img[:1]
        elif self.stain == "PolyT":
            img = img[1:]
        # z window: lose snum//4 boundary slices per side when snum>1
        # (MBADataset.py:111-117)
        shf = self.snum // 4 if self.snum > 1 else 0
        if self.snum > 1:
            pad = np.zeros((img.shape[0], self.spad, self.crop, self.crop),
                           img.dtype)
            img = np.concatenate([pad, img, pad], axis=1)
        img = img[:, snm + shf: snm + self.snum - shf]

        for _ in range(rot):
            img = np.rot90(img, 1, axes=(2, 3))
            gn = gn.rot90()
        if flip:
            img = img[..., ::-1]
            gn = gn.flip_w()

        # (S, Zimg, H, W) -> (H, W, S*Zimg), stain-major channels
        s, zi = img.shape[:2]
        img = np.ascontiguousarray(img.reshape(s * zi, self.crop, self.crop)
                                   .transpose(1, 2, 0))

        if self.pad_bins > 0:
            gn = gn.pad_spatial(self.pad_bins)
        if compact:
            # raw uint8 image + integer counts; the device applies the
            # identical normalization (bit-exact, fewer bytes)
            dense = gn.todense(np.int64)
            if dense.max() >= 2 ** 16:
                raise ValueError("gene bin count overflows uint16")
            return Sample(image=img, rna=dense.astype(np.uint16))
        # x*(1/127.5)-1 rather than x/127.5-1: multiply is correctly
        # rounded on every backend (TPU lowers divide to a refined
        # reciprocal), so the compact path's on-device decode is
        # BIT-identical to this host path (<=1 ulp from the reference's
        # division form — far inside the parity bounds)
        img = img * np.float32(1.0 / 127.5) - np.float32(1.0)
        return Sample(image=img.astype(np.float32),
                      rna=gn.todense(np.float32))

    def order(self) -> np.ndarray:
        """The sample indices of one pass, shuffled."""
        return self.rng.permutation(len(self.paths))

    def __iter__(self) -> Iterator[Sample]:
        for idx in self.order():
            yield self.sample(int(idx))


class SyntheticDataset:
    """Deterministic synthetic MERFISH-like data for tests and smoke runs.

    Blob-structured images with gene counts correlated to intensity, so the
    model has real signal to condition on.
    """

    def __init__(self, *, n: int = 64, crop: int = 256, gdim: int = 32,
                 gblk: int = 16, snum: int = 4, stain: str = "all",
                 pad_bins: int = 2, seed: int = 0):
        self.n, self.crop, self.gdim, self.gblk = n, crop, gdim, gblk
        self.snum, self.stain, self.pad_bins = snum, stain, pad_bins
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def sample(self, idx: int) -> Sample:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        zi = max(1, self.snum // 2)
        s = 2 if self.stain == "all" else 1
        hw = self.crop
        yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
        img = np.zeros((hw, hw, s * zi), np.float32)
        gbins = hw // self.gblk
        rna = np.zeros((gbins, gbins, self.snum * self.gdim), np.float32)
        for _ in range(6):
            cy, cx = rng.random(2)
            sig = 0.05 + 0.15 * rng.random()
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
            ch = rng.integers(0, s * zi)
            img[..., ch] += blob
            g = int(rng.integers(0, self.gdim))
            bl = blob.reshape(gbins, self.gblk, gbins, self.gblk).mean((1, 3))
            for z in range(self.snum):
                rna[..., z * self.gdim + g] += (bl * 20).astype(np.float32)
        img = np.clip(img, 0, 1) * 2 - 1
        rna = np.round(rna)
        if self.pad_bins > 0:
            rna = np.pad(rna, ((self.pad_bins,) * 2, (self.pad_bins,) * 2,
                               (0, 0)))
        return Sample(image=img, rna=rna)

    def order(self) -> range:
        return range(self.n)

    def skip(self, idx: int) -> None:
        """Nothing to draw: a sample's randomness is its own."""

    def __iter__(self) -> Iterator[Sample]:
        for i in self.order():
            yield self.sample(i)


def batches(dataset, batch_size: int, *, drop_last: bool = True,
            prefetch: int = 2, workers: int = 0,
            keep: Sequence[int] | None = None) -> Iterator[dict]:
    """Prefetching batch iterator -> dict of stacked numpy arrays, the
    samples in the order of the dataset's pass (``dataset.order()``).

    ``workers=0``: one background IO thread (enough when samples are cheap
    or the filesystem is fast).  ``workers>0``: that many worker PROCESSES
    decode samples in parallel (the reference forks DataLoader workers,
    config.py:253-278) — zarr decompression + COO block-sum are CPU-bound,
    so scale workers to keep the device fed (scripts/bench_loader.py
    measures samples/s per worker count).

    ``keep``: the positions within each batch of ``batch_size`` to decode;
    the others are skipped (``dataset.skip`` takes the random draws their
    decoding would have taken), so each batch holds the kept rows of the
    batch that ``keep=None`` yields, in their order.
    """
    keep = None if keep is None else frozenset(keep)
    if workers > 0:
        yield from _mp_batches(dataset, batch_size, workers=workers,
                               drop_last=drop_last, prefetch=prefetch,
                               keep=keep)
        return
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def producer():
        try:
            buf_img, buf_rna = [], []
            for pos, idx in enumerate(dataset.order()):
                p = pos % batch_size
                if keep is None or p in keep:
                    s = dataset.sample(int(idx))
                    buf_img.append(s.image)
                    buf_rna.append(s.rna)
                else:
                    dataset.skip(int(idx))
                if p == batch_size - 1:
                    if buf_img:
                        q.put({"image": np.stack(buf_img),
                               "rna": np.stack(buf_rna)})
                    buf_img, buf_rna = [], []
            if buf_img and not drop_last:
                q.put({"image": np.stack(buf_img), "rna": np.stack(buf_rna)})
            q.put(stop)
        except BaseException as e:  # surface decode errors to the consumer
            q.put(e)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def _mp_worker(dataset, wid: int, nw: int, batch_size: int, keep, q) -> None:
    """Worker process: decode every nw-th sample (in order, skipping the
    positions ``keep`` leaves out) and ship it back on its own queue.

    Runs in a spawned process, numpy only.
    Each worker reseeds its RNG so augmentations/crops are independent
    (reference per-worker seeding semantics)."""
    if hasattr(dataset, "rng"):
        dataset.rng = np.random.default_rng(
            np.random.SeedSequence([wid, len(dataset)]))
    try:
        for i in range(wid, len(dataset), nw):
            if keep is None or i % batch_size in keep:
                s = dataset.sample(i)
                q.put((s.image, s.rna))
            else:
                dataset.skip(i)
        q.put(None)
    except Exception as e:  # surface worker crashes to the consumer
        q.put(e)


def _mp_batches(dataset, batch_size: int, *, workers: int,
                drop_last: bool = True, prefetch: int = 4,
                keep: frozenset | None = None) -> Iterator[dict]:
    """Sample ``i`` comes from worker ``i % workers``, whose queue holds
    its samples in order, so reading the queues round-robin yields the
    pass in index order whichever worker is ahead."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    depth = max(2, prefetch * batch_size // workers)
    qs = [ctx.Queue(maxsize=depth) for _ in range(workers)]
    procs = [ctx.Process(target=_mp_worker,
                         args=(dataset, w, workers, batch_size, keep, qs[w]),
                         daemon=True) for w in range(workers)]
    for p in procs:
        p.start()

    def get(w: int):
        while True:
            try:
                item = qs[w].get(timeout=5)
                break
            except queue.Empty:
                if not procs[w].is_alive():
                    raise RuntimeError(f"loader worker {w} died (exit "
                                       f"{procs[w].exitcode})") from None
        if item is None:
            raise RuntimeError(f"loader worker {w} ended early")
        if isinstance(item, Exception):
            raise item
        return item

    n = len(dataset)
    end = n - n % batch_size if drop_last else n
    buf_img, buf_rna = [], []
    try:
        for i in range(end):
            p = i % batch_size
            if keep is None or p in keep:
                img, rna = get(i % workers)
                buf_img.append(img)
                buf_rna.append(rna)
            if (p == batch_size - 1 or i == end - 1) and buf_img:
                yield {"image": np.stack(buf_img), "rna": np.stack(buf_rna)}
                buf_img, buf_rna = [], []
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)

"""The port and chip_smoke.py never load JAX, flax, optax, orbax or the
JAX package (the GPU machine has none of them)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import tera_mind_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import tera_mind_tpu_torch
import chip_smoke
for m in pkgutil.walk_packages(tera_mind_tpu_torch.__path__,
                               "tera_mind_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "tera_mind_tpu"))
print(len([k for k in sys.modules if k.startswith("tera_mind_tpu_torch")]))
print(bad)
"""


def test_port_modules_import_without_jax():
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_loaded, bad = res.stdout.strip().splitlines()[-2:]
    names = {m.name for m in pkgutil.walk_packages(
        tera_mind_tpu_torch.__path__, "tera_mind_tpu_torch.")}
    assert "tera_mind_tpu_torch.parallel.streaming" in names
    assert names >= {f"tera_mind_tpu_torch.{m}" for m in (
        "training.harness", "training.tb", "data.dataset", "data.manifest",
        "diffusion.resample", "cli.train", "ops.quant", "ops.quant_kernel",
        "models.unet_attn", "cli.attn", "cli.evaluate", "metrics",
        "metrics.stats", "metrics.fid", "metrics.ssim", "metrics.features",
        "metrics.inception", "metrics.gene_stats", "metrics.morphology")}
    n_modules = len(names)
    assert int(n_loaded) >= n_modules > 15
    assert bad == "[]", bad

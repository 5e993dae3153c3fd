"""Build and load the port's CUDA kernels: plain ``nvcc`` + ``ctypes``.

All sources under ``tera_mind_tpu_torch/csrc/`` compile into ONE shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds): each ``.cu`` in its own ``nvcc`` process, all started together,
then one link.  The library lands in ``tera_mind_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, and is built at
first use.  Each ``extern "C"`` entry point takes device pointers and the
stream as ``void*`` and the variant the wrapper chose as an ``int``,
returns ``cudaGetLastError()`` after its launch, and the Python wrapper
raises when that is not 0.  ``ptxas`` reports each kernel's registers,
shared memory and spills (``-Xptxas -v``); ``build_log`` keeps that report
of the last build and ``ptxas_report`` condenses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh codes

_ptr, _int, _i64, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
SIGNATURES = {
    "tmt_rmsnorm": [_ptr, _ptr, _ptr, _i64, _int, _f32, _int, _int, _int,
                    _ptr],
    "tmt_window_attention": [_ptr, _ptr, _ptr, _ptr, _int, _int, _int,
                             _f32, _int, _int, _ptr],
    "tmt_rmsnorm_bwd": [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _i64, _int,
                        _int, _f32, _int, _int, _ptr],
    "tmt_window_attention_bwd": [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                                 _ptr, _int, _int, _int, _f32, _int, _int,
                                 _ptr],
    "tmt_quant_conv": [_ptr] * 6 + [_int] * 14 + [_ptr],
    "tmt_quantize": [_ptr] * 6 + [_int, _i64, _int, _int, _int, _int, _ptr],
    "tmt_grouped_rmsnorm": [_ptr, _ptr, _ptr, _ptr, _i64] + [_int] * 5
    + [_f32] + [_int] * 5 + [_ptr, _ptr, _i64, _i64, _ptr],
    "tmt_grouped_rmsnorm_bwd": [_ptr] * 6 + [_i64] + [_int] * 6 + [_f32]
    + [_int] * 3 + [_ptr],
    "tmt_residual": [_ptr] * 5 + [_i64, _int, _int, _int, _ptr],
    "tmt_rmsnorm_modulate": [_ptr, _ptr, _ptr, _i64, _int, _f32, _int, _int,
                             _int, _ptr, _ptr, _i64, _i64, _ptr],
    "tmt_gated_residual": [_ptr] * 4 + [_i64, _int, _i64, _int, _int, _ptr],
}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()   # guards every wrapper's launch counters
build_seconds = None   # wall time of the last build (None: loaded cached)
build_log = ""         # nvcc's and ptxas's output of the last build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc "
                       "on PATH (the kernels build on a CUDA machine)")


def lib_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtmt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile each csrc/*.cu in its own ``nvcc`` process, all started
    together, and link the objects into the hashed .so (no-op if it
    exists)."""
    global build_seconds, build_log
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cus = [s for s in sources() if s.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        work = Path(work)
        jobs = []
        for src in cus:
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   "-o", str(work / f"{src.stem}.o"), str(src)]
            with open(work / f"{src.stem}.log", "w") as log:
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        for _, proc in jobs:
            proc.wait()
        logs = [(work / f"{src.stem}.log").read_text() for src in cus]
        build_log = "".join(logs)
        for (cmd, proc), log in zip(jobs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *[str(work / f"{src.stem}.o") for src in cus]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)   # atomic: a concurrent build sees a whole file
    return out


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel of ``log``: its mangled name (which
    holds the kernel's name), registers, and spill stores/loads."""
    rows, name, spills = [], None, "spills not reported"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), "spills not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spill {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return rows


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


class Counters:
    """Launch counters of one kernel, as a wrapper module keeps its own
    (``launches``, ``launches_by_variant``): the backward kernels'."""

    def __init__(self, variants):
        self.launches = 0
        self.launches_by_variant = dict.fromkeys(variants, 0)


def count_launch(counters, variant: str, epilogue: str = None,
                 prologue: str = None) -> None:
    """Add one launch of ``variant`` to ``counters.launches`` and
    ``counters.launches_by_variant`` (a kernel wrapper module), and of
    ``epilogue`` to its ``launches_by_epilogue`` and ``prologue`` to its
    ``launches_by_prologue`` where given, under one lock: streaming runs
    windows on worker threads, where a bare ``+= 1`` can lose an
    increment."""
    with _count_lock:
        counters.launches += 1
        counters.launches_by_variant[variant] += 1
        if epilogue is not None:
            counters.launches_by_epilogue[epilogue] += 1
        if prologue is not None:
            counters.launches_by_prologue[prologue] += 1


def reset_launches(counters) -> None:
    """Set ``counters.launches`` and every variant's (and epilogue's and
    prologue's) count to 0."""
    with _count_lock:
        counters.launches = 0
        for table in (counters.launches_by_variant,
                      getattr(counters, "launches_by_epilogue", {}),
                      getattr(counters, "launches_by_prologue", {})):
            for name in table:
                table[name] = 0


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def autograd_required(*tensors: torch.Tensor) -> bool:
    """Whether a call on ``tensors`` would have to record a backward:
    grad mode is on and an input requires grad.  The dispatchers
    (``rmsnorm``, ``window_attention``) then go through their
    ``autograd.Function``, whose backward launches K1b or K2b; the raw
    forward launchers refuse such a call instead of returning a detached
    output."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


NO_BACKWARD = ("this raw CUDA launcher records no backward; call the "
               "dispatcher (rmsnorm or window_attention), whose "
               "autograd.Function launches the backward kernels K1b and "
               "K2b, or call it under torch.no_grad() or "
               "torch.inference_mode()")


def refuse_autograd(name: str, *tensors: torch.Tensor,
                    why: str = NO_BACKWARD) -> None:
    if autograd_required(*tensors):
        raise RuntimeError(f"{name}: an input requires grad, but {why}")


def dtype_code(t: torch.Tensor, name: str) -> int:
    try:
        return DTYPES[t.dtype]
    except KeyError:
        raise TypeError(f"{name}: no kernel for dtype {t.dtype}") from None

"""Build and load the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` has a plain C interface.  At first use
each source is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` and the objects are linked into one shared library under
``build/`` at the repository root, which is loaded with ``ctypes``.  The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built when
this module is imported: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["load_library", "check", "stream_of", "DTYPE_CODES", "build_seconds"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parents[1] / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points: (argument types); each returns a cudaError_t as int
_SIGNATURES = {
    "repro_pack": [_P, _P, _I, _L, _L, _L, _L, _L, _L, _I, _I, _P],
    "repro_unpack": [_P, _P, _I, _L, _L, _L, _I, _I, _L, _L, _I, _P],
    "repro_empty_launch": [_I, _P],
    "repro_mmt4d": [_P, _P, _P, _P, _I, _L, _L, _L, _I, _I, _I, _I,
                    _I, _I, _I, _L, _L, _L, _P],
    "repro_ragged_attn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P],
}

build_seconds = 0.0   # wall time of the last build (0.0: reused or not built)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _build(sources: list[Path], target: Path) -> None:
    global build_seconds
    t0 = time.perf_counter()
    nvcc = _nvcc()
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        _run_all([[nvcc, *_ARCH, *_FLAGS, "-c", str(s), "-o", str(o)]
                  for s, o in zip(sources, objs)])
        part = Path(tmp) / target.name
        _run_all([[nvcc, *_ARCH, "-shared", *map(str, objs), "-o", str(part)]])
        os.replace(part, target)
    build_seconds = time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for s in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    target = _BUILD / f"librepro_kernels_{h.hexdigest()[:16]}.so"
    if not target.exists():
        _build(sources, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = load_library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Check that every tensor lies on one CUDA device; return it.  A
    wrapper takes its plain version only for CPU tensors, so anything else
    reaching a kernel is refused here."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors on {[str(x.device) for x in tensors]}"
                             f"; the kernel needs them all on one CUDA device")
    return dev


def require_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> int:
    """Check that every tensor has ``dtype`` (float32 or bfloat16); return
    its code for the C interface."""
    if dtype not in DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in tensors]}; the "
                        f"kernel takes one of {list(DTYPE_CODES)} for all")
    return DTYPE_CODES[dtype]


def require_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous "
                             f"(shape {tuple(t.shape)}, strides {t.stride()})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream

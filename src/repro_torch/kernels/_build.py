"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library ``build/repro_torch_kernels/lib<name>.so`` at the root of
the checkout.  Nothing is built when a module is imported: the first
call to :func:`library` builds every source once per process, one
``nvcc`` per source, all started together.  A failed build raises.

The flags are fixed: ``sm_90a`` (Hopper: ``wgmma`` and ``setmaxnreg``
exist only there), ``-O3``, and no ``--use_fast_math``, which may
rewrite the ``value <= cmp`` comparisons that route NaN rows and would
swap the CUDA-core softmax's ``expf`` for a faster, less accurate one
(the Hopper flash kernel picks its ``ex2.approx`` itself, where its
error is bounded).  No include path or link flag is added: the flash
kernel's TMA tensor maps come from ``cuTensorMapEncodeTiled``, whose
types ``<cuda.h>`` in the toolkit's default include path declares and
which it reaches through ``cudaGetDriverEntryPoint``, so the libraries
need no ``-lcuda``; its ``wgmma``, TMA and ``mbarrier`` code is inline
PTX, without CUTLASS.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` (in parallel) and load the libraries.

    Each library is written under a per-process name and renamed into
    place, so processes building at once do not clobber each other.  The
    compiler's output (``-Xptxas -v``: registers, spills) is kept in
    ``<name>.log`` beside the library.
    """
    with _lock:
        if _libs:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            out = BUILD_DIR / f"lib{src.stem}.so"
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            (BUILD_DIR / f"{src.stem}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for src, out, _, _ in jobs:
            _libs[src.stem] = ctypes.CDLL(str(out))
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]

"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library ``build/repro_torch_kernels/lib<name>.so`` at the root of
the checkout.  Nothing is built when a module is imported: the first
call to :func:`library` builds every source once per process, one
``nvcc`` per source, all started together.  A failed build raises.

A library is keyed by a hash of its source, of the ``csrc/*.cuh``
headers it includes (``hopper.cuh``, which both flash-attention sources
include) and of :data:`NVCC_FLAGS`, written beside it in
``lib<name>.so.key``.  A process that finds a
library whose key matches loads it and runs no ``nvcc``: the ranks of a
distributed fit load the build of the first of them (or of their
parent), and so does a second run of the same checkout.  A changed source
or flag rebuilds.  The build holds a lock on the directory, so processes
that start together build once.

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
import fcntl
import hashlib
import os
import re
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


def _headers(src: Path) -> list[Path]:
    """The headers of ``csrc`` that ``src`` includes (``#include
    "name.cuh"``), and theirs, each once, in the order first included."""
    found: list[Path] = []
    todo = [src]
    while todo:
        text = todo.pop(0).read_text()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            header = src.parent / name
            if header.exists() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def source_key(src: Path) -> str:
    """The hash a library built from ``src`` is kept under: its source, the
    headers it includes and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` whose library is missing or stale (in
    parallel) and load the libraries.

    Each library is written under a per-process name and renamed into
    place, then its key; the compiler's output (``-Xptxas -v``: registers,
    spills) is kept in ``<name>.log`` beside it.
    """
    with _lock:
        if _libs:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            _build_stale()
        for src in sorted(CSRC.glob("*.cu")):
            _libs[src.stem] = ctypes.CDLL(str(BUILD_DIR / f"lib{src.stem}.so"))
        return _libs


def _build_stale() -> None:
    """Run nvcc on every source whose library's key does not match."""
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"lib{src.stem}.so"
        key_file = out.with_name(f"{out.name}.key")
        key = source_key(src)
        if (out.exists() and key_file.exists()
                and key_file.read_text() == key):
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, key_file, key, tmp, proc))
    failed = []
    for src, out, key_file, key, tmp, proc in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        key_file.unlink(missing_ok=True)
        os.replace(tmp, out)
        key_file.write_text(key)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]

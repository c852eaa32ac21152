"""Build a kernel's CUDA sources into a shared library, load it, and
launch its C entry points.

``nvcc`` compiles each kernel's ``csrc/*.cu`` (plain C entry points, no
PyTorch headers: seconds) into ``kernels/build/`` at first use, one
process per source, all started together, then links them into one
shared library; the file name carries a hash of the sources, the headers
beside them and the flags, so an edited source is never served from a
stale build.  Only the machine with the card builds:
this module is imported everywhere, but nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")
BUILD_DIR = Path(__file__).resolve().parent / "build"


def find_nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def build_library(name: str, sources: Sequence[Path]
                  ) -> Tuple[ctypes.CDLL, float, str]:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` (reused when it
    exists) and load it.  Returns ``(library, build seconds, nvcc log)``;
    the seconds are 0 for a reused build."""
    sources = [Path(s) for s in sources]
    headers = sorted({h for s in sources for h in s.parent.glob("*.cuh")})
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*sources, *headers]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
        nvcc = find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                       str(s)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for s, o in zip(sources, objs)]
            log = "".join(p.communicate()[0] for p in procs)
            if any(p.returncode != 0 for p in procs):
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            os.replace(tmp, out)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    return ctypes.CDLL(str(out)), seconds, log


def bind_library(name: str, sources: Sequence[Path],
                 signatures: Dict[str, list]) -> Tuple[ctypes.CDLL, float,
                                                        str]:
    """:func:`build_library`, then declare each C entry point's argument
    types (its result is a ``cudaError_t``, an int)."""
    lib, seconds, log = build_library(name, sources)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, seconds, log


def launch(fn, device: torch.device, *args) -> None:
    """Call C entry point ``fn(*args, stream)`` on ``device`` and PyTorch's
    current stream there (made the current device for the call only);
    raise on a non-zero ``cudaError_t``."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {rc}")

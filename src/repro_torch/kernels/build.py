"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
land in ``build/kernels/`` at the repository root, named by a hash of
their sources and flags, so an edited source is rebuilt and an unchanged
one is reused.  Nothing here runs at import time: the first launch of a
kernel builds it, and :func:`build_all` builds every kernel at once with
one ``nvcc`` per source started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("decode_gqa", "partial_prefill", "attn_importance")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: every pointer (and the stream) is a c_void_p, every size
# a c_int; each entry returns cudaGetLastError() as an int
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "decode_gqa_launch": [_P] * 6 + [_I] * 7 + [_P],
    "partial_prefill_launch": [_P] * 6 + [_I] * 8 + [_P],
    "attn_importance_launch": [_P] * 7 + [_I] * 8 + [_P],
}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {home}; the "
                           f"CUDA kernels cannot be built")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc build; returns (process, target, tmp, log) or None
    when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp, log


def _finish(name: str, job) -> None:
    proc, target, tmp, log = job
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)   # atomic: concurrent builds agree


def build_all() -> dict[str, str]:
    """Build every kernel (one nvcc per source, all started together)
    and return ``{name: ptxas report}``: registers, shared memory and
    spills per instantiation, from the build that made each library.
    Every nvcc started is waited for before a failure is raised."""
    jobs = {n: _start(n) for n in KERNELS}
    errors = []
    for n, job in jobs.items():
        if job is not None:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    reports = {}
    for n in KERNELS:
        log = _lib_path(n).with_suffix(".log")
        reports[n] = log.read_text() if log.exists() else ""
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    job = _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = SIGNATURES[f"{name}_launch"]
    fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib

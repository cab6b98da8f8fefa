"""Build the CUDA kernels at first use and bind them with ctypes.

The sources in ``nucleoatac_torch/csrc`` have a plain C interface, so they
compile with ``nvcc`` alone (seconds; no PyTorch headers; one nvcc per
source, run together) into one shared library under
``<repo>/build/nucleoatac_torch/``, named by a hash of the sources and
flags: an edit to any source rebuilds, an unchanged tree reuses the
library. ``BUILD_LOG`` keeps ptxas's report of each kernel's registers,
shared memory and spills. Nothing is compiled when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nucleoatac_torch"
SOURCES = ("diag_xcorr.cu", "nuc_scores.cu", "occ_window.cu", "bias_mat.cu")
HEADERS = ("xcorr.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# ptxas's report (registers, shared memory, spills per kernel) of the last
# build in this process; empty when the library was already built
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the nucleoatac_torch kernels")


def source_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libnucleoatac_kernels_{source_key()}.so"


def _run(cmds: list) -> list:
    """Run the commands at once; raise on the first that fails. Returns
    each one's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{so}\n{se}")
    return [se for _, se in outs]


def _compile(out: Path) -> str:
    """One nvcc per source, all started together, then one link. Returns
    ptxas's report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{Path(s).stem}.{tag}.o") for s in SOURCES]
    tmp = out.with_suffix(f".{tag}")
    try:
        logs = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                     for s, o in zip(SOURCES, objs)])
        _run([[_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return "".join(logs)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.nucleoatac_diag_xcorr.restype = i32
    lib.nucleoatac_diag_xcorr.argtypes = [p, i64, p, p, i32, i32, i32, i32, p]
    lib.nucleoatac_nuc_scores.restype = i32
    lib.nucleoatac_nuc_scores.argtypes = [
        p, i64, p, i64, p, p, p, p, p, p, i32, i32, i32, i32, ctypes.c_float, p,
    ]
    lib.nucleoatac_occ_window.restype = i32
    lib.nucleoatac_occ_window.argtypes = [
        p, i64, i64, i64, p, i64, p, i32, i32, i32, i32, i32, i32, ctypes.c_float,
        ctypes.c_float, p,
    ]
    lib.nucleoatac_bias_mat.restype = i32
    lib.nucleoatac_bias_mat.argtypes = [p, i64, p, p, i32, i32, i32, i32, i32, i32, p]
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, compiled from ``csrc`` if missing."""
    global _lib, BUILD_LOG
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                BUILD_LOG = _compile(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib

"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. All
sources build at first use, one ``nvcc`` each and all at once, into
``build/torch_kernels/`` beside the package; a library's file name carries
the hash of its sources, so an edit rebuilds it and nothing else does.

Every exported function launches on the stream it is given and returns the
``cudaError_t`` of the launch; :func:`call` raises on anything but 0.
``launches`` counts the launches of each kernel's wrapper: a wrapper adds
one where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# one shared library per source file
SOURCES = ("l2_topk", "heuristic_kept", "pair_sq_l2", "lloyd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: dict[str, int] = {
    "l2_topk": 0, "heuristic_kept": 0, "pair_sq_l2": 0, "lloyd_block": 0,
    "assign_clusters": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple, object] = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}  # source -> ptxas report of its last build


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the seconds spent; raises with the compiler's output if one
    fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log[name] = log
        if p.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                if not _lib_path(name).exists():
                    build_all()
                lib = ctypes.CDLL(str(_lib_path(name)))
                lib.fvdb_error_string.restype = ctypes.c_char_p
                lib.fvdb_error_string.argtypes = [ctypes.c_int]
                _libs[name] = lib
    return lib


P = ctypes.c_void_p  # device pointers and the stream
I = ctypes.c_int  # 32-bit ints


def call(source: str, symbol: str, argtypes: list, *args) -> None:
    """Call ``symbol`` of ``source``'s library; raise on a CUDA error."""
    key = (source, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(_lib(source), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[key] = fn
    err = fn(*args)
    if err != 0:
        msg = _lib(source).fvdb_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")


def check(t, name: str, dtype, dims: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``dims``-D ``dtype`` tensor on
    ``device``: what a kernel's C interface takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dims:
        raise ValueError(f"{name} must have {dims} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

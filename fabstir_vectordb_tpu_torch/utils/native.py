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
import weakref
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# one shared library per source file
SOURCES = ("l2_topk", "heuristic_kept", "pair_sq_l2", "lloyd",
           "greedy_descent", "beam_search", "ivf_scan", "kmeans_seed",
           "stage1_select", "project_rows", "rerank_f32", "merge_topk",
           "synth", "approx_topk", "quantize", "pq", "shard_merge")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: dict[str, int] = {
    "l2_topk": 0, "l2_topk_large": 0, "l2_topk_bf16": 0,
    "l2_topk_bf16_rq": 0, "heuristic_kept": 0, "heuristic_kept_bf16": 0,
    "pair_sq_l2": 0, "pair_sq_l2_bf16": 0, "lloyd_block": 0,
    "assign_clusters": 0, "greedy_descent": 0, "greedy_descent_bf16": 0,
    "beam_search": 0, "beam_search_bf16": 0, "beam_search_up": 0,
    "beam_search_bf16_up": 0, "ivf_scan": 0, "ivf_scan_bf16": 0,
    "seed_pick": 0, "seed_min_update": 0, "seed_counts": 0,
    "stage1_select": 0, "project_rows": 0, "project_queries": 0,
    "rerank_f32": 0, "rerank_f32_rows": 0, "merge_topk": 0, "synth_rows": 0,
    "approx_topk": 0, "approx_topk_f32": 0, "approx_topk_bf16": 0,
    "approx_topk_bf16_rq_fma": 0, "chunk_step": 0, "quantize_u8": 0,
    "dequantize_u8": 0, "pq_encode": 0, "pq_decode": 0, "pq_adc_table": 0,
    "pq_adc_distances": 0, "lloyd_partial": 0, "lloyd_finish": 0,
    "shard_merge": 0, "set_rows": 0, "set_member_rows": 0, "masked_topk": 0,
    "masked_approx_topk": 0, "lloyd_step": 0, "kmeans_pp": 0,
}
# K1 on each row type at a shape the tensor-core pass does not take
# (csrc/bf16_tile.cuh): l2_tile.cuh's FMA pass
for _base in ("l2_topk", "l2_topk_large", "l2_topk_bf16", "l2_topk_bf16_rq"):
    launches[f"{_base}_fma"] = 0
# K4 at rows that cp.async cannot copy 16 bytes at a time: the FMA route
# ("heuristic_kept" and "heuristic_kept_bf16" count the tensor cores)
launches["heuristic_kept_fma"] = 0
launches["heuristic_kept_bf16_fma"] = 0
# K6 on its FMA tile, at the shapes its tensor-core route does not take
# (ops/kmeans.py lloyd_route; the names without "_fma" count the tensor
# cores)
for _base in ("assign_clusters", "lloyd_block", "lloyd_partial",
              "lloyd_step"):
    launches[f"{_base}_fma"] = 0
# K7's kmeans|| table update and counts on the FMA tile, at the shapes the
# tile pass does not take (ops/kmeans.py lloyd_route; "seed_min_update" and
# "seed_counts" count the tensor cores)
launches["seed_min_update_fma"] = 0
launches["seed_counts_fma"] = 0
# K9 on f32 rows on the tensor cores (three TF32 products; "approx_topk_f32"
# counts the FMA pass)
launches["approx_topk_tf32"] = 0
# K14's stage 1 on the FMA pass and its [B, N] buffer (a launch each): at a
# rank the tensor-core pass does not take ("_fma"), and where a launch of
# the filter route had survivors past their buffer ("_overflow")
launches["stage1_select_fma"] = 0
launches["stage1_select_overflow"] = 0
# K1 on f32 rows by euclidean distance: a chunk of the filter route whose
# survivors passed their buffer, run again on the lists or the buffer
# (whose launches count under their own names)
launches["l2_topk_overflow"] = 0
# K2 past the pool that its kernel selects in shared memory: the distance
# buffer and topk_select.cuh's radix select ("rerank_f32" and
# "rerank_f32_rows" count the fused route)
launches["rerank_f32_radix"] = 0
launches["rerank_f32_rows_radix"] = 0
# K1 and K12 by metric: "<counter>_cosine", "<counter>_dot"
for _base in ("l2_topk", "l2_topk_large", "l2_topk_bf16_rq",
              "l2_topk_fma", "l2_topk_large_fma", "l2_topk_bf16_rq_fma",
              "ivf_scan", "ivf_scan_bf16"):
    for _metric in ("cosine", "dot"):
        launches[f"{_base}_{_metric}"] = 0


# launches of K2, K6, K7, K10 and K11 by shape ("<counter> <shape>"): the
# wrappers add one beside their counter's, and reset_launches clears them
# with it
shape_launches: dict[str, int] = {}


def count_shape(name: str, shape: str) -> None:
    """One launch of counter ``name`` at ``shape``."""
    key = f"{name} {shape}"
    shape_launches[key] = shape_launches.get(key, 0) + 1


def counter(base: str, bf16: bool = False, metric: str = "euclidean",
            up: bool = False, rq: bool = False, fma: bool = False) -> str:
    """The launch counter of a kernel's variant: ``base``, then "_bf16"
    for bf16 rows, "_rq" for the query rounded to bf16, "_fma" for K1 or K4
    on the FMA pass (a shape the tensor-core pass does not take), "_up" for a
    layer above 0, "_<metric>" for cosine or dot."""
    name = (base + ("_bf16" if bf16 else "") + ("_rq" if rq else "")
            + ("_fma" if fma else "") + ("_up" if up else ""))
    return name if metric == "euclidean" else f"{name}_{metric}"


_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple, object] = {}
_lock = threading.Lock()
build_log: dict[str, str] = {}  # source -> ptxas report of its last build


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    shape_launches.clear()


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
    for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
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
L = ctypes.c_longlong  # 64-bit ints
U = ctypes.c_uint  # 32-bit unsigned ints (PRNG key words)
F = ctypes.c_float


def _fn(source: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    key = (source, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(_lib(source), symbol)
        fn.restype = restype
        fn.argtypes = argtypes
        _fns[key] = fn
    return fn


def query(source: str, symbol: str, argtypes: list, *args) -> int:
    """Call a host-side helper of ``source``'s library that returns a
    64-bit number (no launch)."""
    return int(_fn(source, symbol, argtypes, ctypes.c_longlong)(*args))


def call(source: str, symbol: str, argtypes: list, *args) -> None:
    """Call ``symbol`` of ``source``'s library; raise on a CUDA error."""
    raise_on(_fn(source, symbol, argtypes)(*args), source, symbol)


def fn(source: str, symbol: str, argtypes: list):
    """``symbol`` of ``source``'s library with its argument types set, for
    a caller that launches it many times: it returns the cudaError_t as an
    int, for :func:`raise_on`."""
    return _fn(source, symbol, argtypes)


def raise_on(err: int, source: str, symbol: str) -> None:
    """Raise if ``err``, returned by ``symbol`` of ``source``, is a CUDA
    error."""
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


_passed: dict[str, weakref.ref] = {}


def check_once(t, name: str, dtype, dims: int, device) -> None:
    """:func:`check`, skipped when ``t`` is the very tensor that last
    passed it under ``name`` (a live tensor keeps its type, device, shape
    and layout): the state a kernel is called with again and again, such
    as a mirror, is checked once."""
    ref = _passed.get(name)
    if ref is not None and ref() is t:
        return
    check(t, name, dtype, dims, device)
    _passed[name] = weakref.ref(t)


def stream_of(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an int (the raw
    handle, read without building a ``torch.cuda.Stream``: a few
    microseconds less a call, which small launches feel)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream

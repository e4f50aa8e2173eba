"""Vector quantization (K16): u8 scalar quantization and product
quantization (PQ) with asymmetric distance computation (ADC).

The JAX package's ``ops/quantization.py`` with PyTorch inside. u8 codes and
their decode are csrc/quantize.cu; PQ's encode, decode, lookup tables and
the ADC scan are csrc/pq.cu; PQ training seeds every subspace with K7's
k-means++ in one launch (the reference vmaps kmeans_train over them), then
runs K6's Lloyd on each. Each kernel has a plain version here, which the
wrappers take on CPU tensors; on CUDA tensors they launch the kernel or
raise. Training keys its draws by one draw from a ``torch.Generator``
where the reference splits a JAX key over the subspaces.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import native
from ..utils.device import resolve_device
from .kmeans import _lloyd_until, kmeans_pp_rows, pp_seed

_PLAIN_ELEMS = 1 << 25  # distances a block of pq_encode's plain version


def quantize_u8_plain(x):
    mins = x.min(1).values
    maxs = x.max(1).values
    # a tensor divisor: PyTorch on the card multiplies by the reciprocal of
    # a Python scalar, which is not the IEEE quotient the reference takes
    scales = torch.where(maxs > mins,
                         (maxs - mins) / torch.full_like(mins, 255.0),
                         torch.ones_like(mins))
    codes = torch.round((x - mins[:, None]) / scales[:, None])
    return codes.clamp(0, 255).to(torch.uint8), mins, scales


def quantize_u8(x):
    """Per-row u8 scalar quantization of x [N, D] f32: (codes u8 [N, D],
    mins [N], scales [N]); scale = (max - min) / 255 where max > min, else
    1, codes rounded half to even."""
    if x.device.type == "cpu":
        return quantize_u8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_u8: unsupported device {x.device}")
    dev = x.device
    native.check(x, "x", torch.float32, 2, dev)
    n, d = x.shape
    if n == 0 or d == 0:
        raise ValueError(f"quantize_u8 takes rows of >= 1 dims, got "
                         f"{tuple(x.shape)}")
    codes = torch.empty((n, d), dtype=torch.uint8, device=dev)
    mins = torch.empty(n, dtype=torch.float32, device=dev)
    scales = torch.empty(n, dtype=torch.float32, device=dev)
    P, I = native.P, native.I
    native.call("quantize", "fvdb_quantize_u8", [P, I, I, P, P, P, P],
                x.data_ptr(), n, d, codes.data_ptr(), mins.data_ptr(),
                scales.data_ptr(), native.stream_of(x))
    native.launches["quantize_u8"] += 1
    return codes, mins, scales


def dequantize_u8_plain(codes, mins, scales):
    return codes.to(torch.float32) * scales[:, None] + mins[:, None]


def dequantize_u8(codes, mins, scales):
    """codes * scale + min, row by row: f32 [N, D]."""
    if codes.device.type == "cpu":
        return dequantize_u8_plain(codes, mins, scales)
    if codes.device.type != "cuda":
        raise ValueError(f"dequantize_u8: unsupported device "
                         f"{codes.device}")
    dev = codes.device
    native.check(codes, "codes", torch.uint8, 2, dev)
    native.check(mins, "mins", torch.float32, 1, dev)
    native.check(scales, "scales", torch.float32, 1, dev)
    n, d = codes.shape
    if mins.shape[0] != n or scales.shape[0] != n or n == 0 or d == 0:
        raise ValueError("shape mismatch in dequantize_u8")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    P, I = native.P, native.I
    native.call("quantize", "fvdb_dequantize_u8", [P, P, P, I, I, P, P],
                codes.data_ptr(), mins.data_ptr(), scales.data_ptr(), n, d,
                out.data_ptr(), native.stream_of(codes))
    native.launches["dequantize_u8"] += 1
    return out


@dataclass(frozen=True)
class PQCodebook:
    """Trained PQ codebook: [M, K, Ds] centroids for M subspaces of width
    Ds."""

    centroids: torch.Tensor  # [M, K, Ds] f32
    dim: int

    @property
    def n_subspaces(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_codes(self) -> int:
        return self.centroids.shape[1]


def _subspace(x, m: int, ds: int):
    return x[:, m * ds:(m + 1) * ds].contiguous()


def _pq_train_from(x, init, max_iterations: int = 25,
                   n_codes: int | None = None) -> PQCodebook:
    """Lloyd on each subspace of x [N, D] from init [M, k_eff, Ds], every
    row in; the codebook padded to ``n_codes`` with copies of each
    subspace's centroid 0."""
    n, d = x.shape
    m_sub, k_eff, ds = init.shape
    mask = torch.ones(n, dtype=torch.bool, device=x.device)
    cents = torch.stack([
        _lloyd_until(_subspace(x, m, ds), mask, init[m].contiguous(),
                     max_iterations).centroids for m in range(m_sub)])
    if n_codes is not None and k_eff < n_codes:
        pad = cents[:, :1].expand(m_sub, n_codes - k_eff, ds)
        cents = torch.cat([cents, pad], dim=1)
    return PQCodebook(centroids=cents.contiguous(), dim=d)


def pq_train(gen: torch.Generator, x, n_subspaces: int = 8,
             n_codes: int = 256, max_iterations: int = 25,
             device=None) -> PQCodebook:
    """Per-subspace k-means codebooks (k-means++ then Lloyd, tol 1e-4) of
    x [N, D], D divisible by ``n_subspaces``. min(n_codes, N) codes are
    trained and the rest are copies of code 0. Numpy input goes to
    ``device`` (None: the card); a tensor stays where it is, and ``gen``
    must be on that device."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
    else:
        x = torch.from_numpy(np.asarray(x, np.float32)).to(
            resolve_device(device))
    n, d = x.shape
    if d % n_subspaces != 0:
        raise ValueError(f"dim {d} not divisible by n_subspaces "
                         f"{n_subspaces}")
    ds = d // n_subspaces
    k_eff = min(n_codes, n)
    return _pq_train_from(x, pq_seeds(gen, x, n_subspaces, k_eff),
                          max_iterations, n_codes)


def pq_seeds(gen: torch.Generator, x, n_subspaces: int, k: int,
             plain: bool = False):
    """k-means++'s k starting centroids in each subspace of x [N, D], every
    row in: [M, k, Ds], all M subspaces in one launch on the card (one
    draw from ``gen`` keys them)."""
    n, d = x.shape
    ds = d // n_subspaces
    mask = torch.ones(n, dtype=torch.bool, device=x.device)
    rows = kmeans_pp_rows(pp_seed(gen), x, mask, k, n_subspaces, plain)
    sub = torch.arange(n_subspaces, device=x.device)[:, None]
    return x.reshape(n, n_subspaces, ds)[rows.long(), sub]


def _pq_args(cents, x, what: str):
    dev = x.device
    native.check(cents, "codebook_centroids", torch.float32, 3, dev)
    m, k, ds = cents.shape
    if x.shape[1] != m * ds or x.shape[0] == 0:
        raise ValueError(f"{what}: rows {tuple(x.shape)} against a "
                         f"codebook {tuple(cents.shape)}")
    if k > 256:
        raise ValueError(f"{what}: u8 codes take K <= 256, got {k}")
    return dev, m, k, ds


def _sub_dists(cents, v):
    """|v|^2 - 2 v.c + |c|^2 by subspace, unclamped: [M, B, K] for v
    [B, M Ds]."""
    m, _, ds = cents.shape
    vs = v.reshape(v.shape[0], m, ds).transpose(0, 1)  # [M, B, Ds]
    return ((vs * vs).sum(-1)[:, :, None]
            - 2.0 * torch.bmm(vs, cents.transpose(1, 2))
            + (cents * cents).sum(-1)[:, None, :])


def pq_encode_plain(cents, x):
    m, k, _ = cents.shape
    out = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    rows = max(1, _PLAIN_ELEMS // (m * k))
    for lo in range(0, x.shape[0], rows):
        d = _sub_dists(cents, x[lo:lo + rows])
        out[lo:lo + rows] = d.argmin(-1).T.to(torch.uint8)
    return out


# codes below which the encode keeps its FMA route: the tensor-core route
# takes them 128 a pass (as K6's LLOYD_TC_MIN_C)
PQ_TC_MIN_K = 64


def pq_encode_route(k: int, ds: int, aligned: bool = True) -> str:
    """The encode's route for K = k codes of ds dims: "tf32x3" (K6's tile
    pass, csrc/lloyd_tile.cuh: three TF32 products on the tensor cores;
    TMA copies 16-byte rows) at ds % 4 == 0, k >= PQ_TC_MIN_K and x and
    the codebook 16-byte aligned, else "fma" (csrc/pq.cu's FMA
    kernels)."""
    return "tf32x3" if ds % 4 == 0 and k >= PQ_TC_MIN_K and aligned \
        else "fma"


def pq_encode(codebook_centroids, x):
    """Encode x [N, D] f32 -> codes u8 [N, M]: each subspace's first code
    of least |x|^2 - 2 x.c + |c|^2. On the card by the route
    :func:`pq_encode_route` picks (counted as "pq_encode" on the tensor
    cores, "pq_encode_fma" on the FMA route)."""
    if x.device.type == "cpu":
        return pq_encode_plain(codebook_centroids, x)
    if x.device.type != "cuda":
        raise ValueError(f"pq_encode: unsupported device {x.device}")
    native.check(x, "x", torch.float32, 2, x.device)
    dev, m, k, ds = _pq_args(codebook_centroids, x, "pq_encode")
    n = x.shape[0]
    aligned = (x.data_ptr() % 16 == 0
               and codebook_centroids.data_ptr() % 16 == 0)
    tc = pq_encode_route(k, ds, aligned) == "tf32x3"
    codes = torch.empty((n, m), dtype=torch.uint8, device=dev)
    scratch = None
    if tc:
        size = native.query("pq", "fvdb_pq_encode_scratch",
                            [native.I, native.I, native.I], m, k, ds)
        scratch = torch.empty(size, dtype=torch.float32, device=dev)
    P, I = native.P, native.I
    native.call("pq", "fvdb_pq_encode", [P, P, I, I, I, I, I, P, P, P],
                x.data_ptr(), codebook_centroids.data_ptr(), n, m, k, ds,
                int(tc), 0 if scratch is None else scratch.data_ptr(),
                codes.data_ptr(), native.stream_of(x))
    name = "pq_encode" if tc else "pq_encode_fma"
    native.launches[name] += 1
    native.count_shape(name, f"N={n} M={m} K={k} Ds={ds}")
    return codes


def pq_decode_plain(cents, codes):
    m, k, ds = cents.shape
    idx = codes.long().clamp_max(k - 1)
    sub = torch.arange(m, device=codes.device)[None, :]
    return cents[sub, idx].reshape(codes.shape[0], m * ds)


# csrc/pq.cu's decode tile route: a block's codebook bytes (DEC_CB), its
# threads (DEC_T; a thread a float4 of a row segment) and the subspaces
# whose codes it stages (DEC_MAX_M)
PQ_DECODE_CB_BYTES = 196_608
PQ_DECODE_THREADS = 768
PQ_DECODE_MAX_M = 512


def pq_decode_route(m: int, k: int, ds: int, aligned: bool = True) -> str:
    """The decode's route for M = m subspaces of K = k codes of ds dims:
    "tile" (csrc/pq.cu: each block's group of subspaces' codebook in
    shared memory, 16-byte streaming stores) at ds % 4 == 0, a subspace's
    codebook within PQ_DECODE_CB_BYTES, ds / 4 <= PQ_DECODE_THREADS, m <=
    PQ_DECODE_MAX_M and codes and codebook 16-byte aligned, else
    "any" (4-byte stores, any shape)."""
    return "tile" if (ds % 4 == 0 and aligned and m <= PQ_DECODE_MAX_M
                      and 4 * k * ds <= PQ_DECODE_CB_BYTES
                      and ds // 4 <= PQ_DECODE_THREADS) else "any"


def pq_decode(codebook_centroids, codes):
    """Decode codes u8 [N, M] -> approximate rows f32 [N, D]. On the card
    by the route :func:`pq_decode_route` picks (counted as "pq_decode" on
    the tile route, "pq_decode_any" on the other)."""
    if codes.device.type == "cpu":
        return pq_decode_plain(codebook_centroids, codes)
    if codes.device.type != "cuda":
        raise ValueError(f"pq_decode: unsupported device {codes.device}")
    dev = codes.device
    native.check(codes, "codes", torch.uint8, 2, dev)
    native.check(codebook_centroids, "codebook_centroids", torch.float32, 3,
                 dev)
    m, k, ds = codebook_centroids.shape
    n = codes.shape[0]
    if codes.shape[1] != m or n == 0:
        raise ValueError("shape mismatch in pq_decode")
    # a fresh output is 16-byte aligned: the route reads the inputs'
    aligned = (codes.data_ptr() | codebook_centroids.data_ptr()) % 16 == 0
    out = torch.empty((n, m * ds), dtype=torch.float32, device=dev)
    tile = pq_decode_route(m, k, ds, aligned) == "tile"
    P, I = native.P, native.I
    native.call("pq", "fvdb_pq_decode", [P, P, I, I, I, I, I, P, P],
                codes.data_ptr(), codebook_centroids.data_ptr(), n, m, k, ds,
                int(tile), out.data_ptr(), native.stream_of(codes))
    name = "pq_decode" if tile else "pq_decode_any"
    native.launches[name] += 1
    native.count_shape(name, f"N={n} M={m} K={k} Ds={ds}")
    return out


def pq_adc_table_plain(cents, q):
    return _sub_dists(cents, q).transpose(0, 1).contiguous()


def pq_adc_table(codebook_centroids, q):
    """ADC lookup tables for queries q [B, D] -> [B, M, K] squared
    distances of each query's subvectors to each code."""
    if q.device.type == "cpu":
        return pq_adc_table_plain(codebook_centroids, q)
    if q.device.type != "cuda":
        raise ValueError(f"pq_adc_table: unsupported device {q.device}")
    native.check(q, "q", torch.float32, 2, q.device)
    dev, m, k, ds = _pq_args(codebook_centroids, q, "pq_adc_table")
    b = q.shape[0]
    table = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    P, I = native.P, native.I
    native.call("pq", "fvdb_pq_adc_table", [P, P, I, I, I, I, P, P],
                q.data_ptr(), codebook_centroids.data_ptr(), b, m, k, ds,
                table.data_ptr(), native.stream_of(q))
    native.launches["pq_adc_table"] += 1
    return table


def pq_adc_distances_plain(table, codes):
    """M gathers summed in place, in subspace order (the reference's one-hot
    product would hold [N, M, K]); a code past K adds 0."""
    b, m, k = table.shape
    padded = torch.nn.functional.pad(table, (0, 256 - k)) if k < 256 \
        else table
    idx = codes.long()
    out = torch.zeros((b, codes.shape[0]), dtype=torch.float32,
                      device=table.device)
    for j in range(m):
        out += padded[:, j].index_select(1, idx[:, j])
    return out


def pq_adc_distances(table, codes):
    """Sum table lookups: table [B, M, K], codes [N, M] -> squared
    distances [B, N]."""
    if table.device.type == "cpu":
        return pq_adc_distances_plain(table, codes)
    if table.device.type != "cuda":
        raise ValueError(f"pq_adc_distances: unsupported device "
                         f"{table.device}")
    dev = table.device
    native.check(table, "table", torch.float32, 3, dev)
    native.check(codes, "codes", torch.uint8, 2, dev)
    b, m, k = table.shape
    n = codes.shape[0]
    if codes.shape[1] != m or n == 0 or b == 0 or k > 256:
        raise ValueError("shape mismatch in pq_adc_distances")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    P, I = native.P, native.I
    native.call("pq", "fvdb_pq_adc_distances", [P, P, I, I, I, I, P, P],
                table.data_ptr(), codes.data_ptr(), b, n, m, k,
                out.data_ptr(), native.stream_of(table))
    native.launches["pq_adc_distances"] += 1
    return out

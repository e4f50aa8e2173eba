#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fabstir_vectordb_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: needs one NVIDIA GPU

1. Probe: the card, torch / CUDA / nvcc versions; build every CUDA kernel
   from ``fabstir_vectordb_tpu_torch/csrc`` (one nvcc each, in parallel).
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, with its time, the plain version's
   time and its bound (the larger of bytes / 3.35 TB/s and flops / 67
   TFLOP/s f32, or 989 TFLOP/s for bf16 products, the H100 SXM data-sheet
   rates). Among them B1-B4: the pipelined build's member scatter, one
   Lloyd step, the exact and binned masked top-k of a [128, 1M] distance
   matrix (k = 16, 1,024 and past N; k = 128), each against its plain
   version and, where one PyTorch call computes the same, timed beside it.
3. Main path, flat regime: a session (``device=None``: the card) ingests a
   seeded Gaussian mixture of 100,000 x 384 vectors with metadata in
   batches of 10,000, answers single, batched and filtered searches,
   deletes 1,000 ids and searches again. Every answer is held against an
   exact float64 numpy brute force. The launch counters, set to 0 just
   before, must show every kernel of the path.
4. The 1M index: bench.py's 1M tier (1,000,000 x 384, 10% recent rows in
   HNSW, 90% in a 256-list IVF) built through ``HybridIndex.insert_batch``;
   the counters must show K7's kernels in the IVF training, and K7 is held
   against its plain version at the training shape.
5. Pruned phase: the index served in the pruned regime (FVDB_PCA_SERVE=0,
   flat threshold 0, as bench.py forces it): single and batched k=10
   searches with recall@10 against the flat regime's exact answers,
   per-engine k, filtered searches at k=10 and 100, k=300, 1,000 deletes
   (the entry point among them), and 2,048 inserts linked through the beam
   plan. The counters must show K1, K4, K5, K6, K10, K11 and K12. Then K10
   (at B = 128 and 1, its bound the larger of its bytes and its longest
   walk's hops x one dependent read from L2), K11, K12, K13 and K1 at k =
   1,024 and 16,384 against their plain versions on the index's own
   state; K12 with its stages' device time
   apart (the grouped route's work list, scan and select, from
   torch.profiler's kernel records) and the list rows it reads as
   modelled from its probes beside the distinct rows a bound counts, at
   B = 1 (the per-query route) and with every query probing the longest
   list.
6. Reduced phase: the same index in the reduced-rank regime, the default
   above the flat threshold, as bench.py's bench_pca serves it (flat
   threshold 0, FVDB_PCA_RERANK=device, rank and oversample auto): the
   state build, 100 single and 8 x 128 batched k=10 searches, recall@10
   against the flat regime's exact answers, filtered searches, no full-dim
   f32 mirror held; host stage 2, the pinned restart, 1,000 deletes and a
   fresh insert, the release on FVDB_PCA_SERVE=0. The counters must show
   K14 (selection, projection), K2, K8 and K1 on bf16 rows; then each
   against its plain version on the regime's own state (K2 at B = 128 and
   1 on its fused select, and a filtered search's pool of 16,384 on its
   radix route).
7. Flat1m phase: the same index in the flat regime at the default
   threshold, as bench.py's turbo phase (FVDB_FLAT_SELECT=approx) and the
   eager half of its cold-start phase (FVDB_SERVING_DTYPE=bfloat16) serve
   it: turbo single, batched and pipelined searches with recall@10 >= 0.95
   against the exact f32 oracle streamed by TieredFlatSearcher, a filtered
   batch and 1,000 deletes (none returned); bf16 serving in four modes
   (host refine: recall@10 >= 0.95 and scores equal to the f64 distances
   of their rows; device re-score: recall@10 >= 0.95 against a float64
   brute force over the bf16-stored rows; raw; approx), the mirror's bytes
   and the prewarm + first search; 2,048 inserts linked on the bf16 mirror,
   >= 99% found at rank 1. The counters must show K9 on the tensor cores
   on f32 and on bf16 rows, K2 on f32 and bf16 rows, K1 on bf16
   rows with the query rounded (tensor cores) and (K3) not, K4 and K5 on
   bf16 rows; then those against their plain versions at these shapes (K1
   rounded also at B = 1, k = 128), each with its pass (tile_pass) and,
   for the rounded query, a bf16 torch.matmul of the same product beside
   it (gemm_ms).
8. Engines phase: the same index, the graph and list engines at every row
   type and metric. The pruned regime on a bf16 mirror
   (FVDB_SERVING_DTYPE=bfloat16, FVDB_PCA_SERVE=0, flat threshold 0): 256
   single and 8 x 128 batched k=10 searches, recall@10 >= 0.85 against the
   exact f32 answers streamed by TieredFlatSearcher and >= 0.95 against a
   float64 brute force over the bf16-stored rows, a filtered batch, 1,000
   deletes (none returned), standalone HNSW and IVF search, 2,048 inserts
   through the layer-0 plan; 2,048 inserts through the per-layer plan on
   each mirror (>= 99% at rank 1, K11 above layer 0); FlatIndex and
   IVFIndex by metric (cosine, dot) on each mirror against float64 brute
   forces, the IVF at every probe against the flat index over its members,
   at 16 probes its recall. The counters must show K10, K11 (layer 0 and
   above), K12 and K1 on bf16 rows and by metric; then K10, K11, K12, K13
   and K1 (by metric, k 16 and 1,024) against their plain versions on this
   state, and chunked_topk over negative distances.
9. Scale phase: bench.py's 10M tier (bench_10m) after the 1M state is
   freed: 10,000,000 x 384 rows of the procedural corpus made on the card
   by K17, registered and filled block by block with each block's IVF
   assignment (K6), the IVF trained on the first 10,000 rows, the source
   spot-checked and attached; then the reduced-rank regime at bench.py's
   operating point with its 8 GB rerank mirror generated by K17: the first
   search (its stages timed), 100 single and 5 x 128 batched searches,
   recall@10 >= 0.95 against the exact f32 oracle that TieredFlatSearcher
   streams from the host (K1 + K8's merge a tile). The counters must show
   K17, K6, K14, K2 and the tile step's K1 and merge; then those kernels
   against their plain versions at this tier's shapes, no full-dim f32
   mirror held, the source-built mirror against a host upload, 1,000
   deletes (the source stays) and a fill (it goes), and one rebuild with
   rank and oversample on auto. The host needs ~45 GB (a 25.8 GB store at
   16,777,216 rows of capacity).
10. Quant phase: k-means and quantization (K7's k-means++ and training
   loop, K16) on bench.py's 1M tier rows, before the scale phase and after
   the engines phase: kmeans_train on the first 65,536 rows (C = 256,
   reported beside kmeans_train_stepped's kmeans|| error); at M = 8 and 48
   subspaces (K = 256) a PQ codebook trained on those rows, every row
   encoded, tables for 128 queries drawn as bench.py draws them, the ADC
   scan [128, 1M] and its top-10 by chunked_topk (recall@10 against K1's
   exact top-10 reported); every row u8-quantized and decoded. Hard: the
   ADC distances equal the exact distances to the decoded rows (4,096-row
   sample, 1e-4 relative), re-encoded decoded rows keep their codes, each
   u8 element within half a step. The counters must show K7's pick and
   min-update, K6 and every K16 kernel; then each against its plain
   version at these shapes (k-means++'s picks equal to a key tie, the
   trained errors within 1%, K6's Lloyd run step by step: each step within
   1e-5 max|x| of the plain step from its centroids, rows sent apart only
   at a float64 tie).
11. Parallel phase: the multi-shard layer (K15, ``parallel/``) on the same
   1M index, after the quant phase: shard meshes of 4, 1 and 2 x 2 shards
   on the card and a NCCL process group of one rank. Flat exact search (k
   = 10 and 200) equal to one K1 call over the mirror up to ties, 1,000
   masked rows never returned; the approx select at recall@10 >= 0.95; the
   projected stage 1 (ov_k = 2,048) holding single-device stage 1's top-10
   at overlap >= 0.99; the IVF search from the index's own centroids and
   tiles equal to one K12 call, its packed shard state's bytes beside the
   padded layout's; the 2 x 2 mesh equal to the 1D one; Lloyd to the stop
   rule from the index's centroids against single-device Lloyd (the same
   iterations, error within 1%, centroids within 1e-5 max|x|);
   sharded_kmeans_train; sharded_assign_clusters equal to one assignment
   call (also from a host array one row short of a multiple of 4); the
   query-sharded HNSW equal to one K10 + K11 call; the hybrid at
   recall@10 >= 0.95; ShardedBuilder: a 20,000-row graph identical at 1
   and 4 shards, 2,048 inserts into the 1M graph >= 99% at rank 1;
   persistence saved at 4 shards and loaded at 2, search bit-identical
   (flat 1M; IVF on 16 lists). The counters must show every kernel of the
   path; then the shard merge (each route by S * k_s, 30 to 20,000, with
   -1 rows and NaN distances in mid-list and a row map that drops rows;
   at its four path shapes its device and host microseconds beside
   torch.topk's), set-rows, K6's partial and finish, K12 with a list range
   and each composition against their plain versions.
12. Cold phase: bench.py's cold-start tier (bench_cold_serve) on the same
   1M index, after the parallel phase: the chunked save to a
   MemoryObjectStore; a lazy load (its serve-ready time: the sidecars), the
   first search answered by on-demand chunk fetches while the
   ``fvdb-materialize`` thread fills the rows and stages their uploads on a
   side stream; with it parked, 32 cold answers against a float64 brute
   force over each one's plan and 8 that probe every list against the warm
   index; the time to full materialization and the staged mirror
   installed; 2,048 inserts into the loaded index through the pipelined
   build, >= 99% found at rank 1; the ops entry points over the loaded rows
   (masked_topk against float64, masked_approx_topk's recall@10, a Lloyd
   step); IVFPersister.migrate_index of a 65,536-row IVF index from 64 to
   128 lists, retrained on the card; an eager load onto a bf16 mirror, its
   prewarm + first search, its answers against a float64 brute force. The
   counters, from 0, must show B1-B4.
13. One JSON line with every kernel's numbers (K6 on its FMA tile, the
   flat tier's 3 lists, as ``lloyd_block_fma``), the routes the main path
   takes only off its shapes ("route_checks"), K2's, K6's, K10's and K11's
   launches by shape on each phase's main path ("launches_by_shape", so
   that a cost can be ordered by each shape's launches times that shape's
   time), the
   card's name and power limit, then ``{"ok": true, "device": {...}}`` as
   the last line.

Any failed check exits non-zero before the last line. ``--phase kernels``
stops after step 2, ``--phase pruned`` runs steps 1, 4 and 5 only,
``--phase reduced`` steps 1, 2, 4 and 6, ``--phase flat1m`` steps 1, 4 and
7, ``--phase engines`` steps 1, 4 and 8, ``--phase quant`` steps 1 and 10
(the 1M rows made, no index), ``--phase parallel`` steps 1, 4 and 11,
``--phase cold`` steps 1, 2, 4 and 12, ``--phase scale`` steps 1 and 9;
``--profile`` writes cProfiles of step 3's ingest and searches to ``--out`` (the timings
then carry the profiler's overhead); ``--trace`` runs searches under
``torch.profiler``, prints the device's busy share and writes the ops by
device time there too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

CORPUS_ROWS = 100_000  # the repo's headline bench tier, at 384 dimensions
PRUNED_ROWS = 1_000_000  # bench.py's 1M tier (build_index)
SCALE_ROWS = 10_000_000  # bench.py's 10M tier (bench_10m)
SCALE_BLOCK_ROWS = 1 << 20  # its generation blocks (utils/synth.py)
QUANT_TRAIN_ROWS = 65_536  # K6's IVF training shape; 256 x K for PQ
QUANT_QUERIES = 128
QUANT_SAMPLE = 4_096  # rows of the ADC-against-decoded check
ADC_CHUNK = 131_072  # chunked_topk's chunk over the ADC distances
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (no TF32)
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
# H100 SXM int32: 64 lanes an SM (Hopper white paper) x 132 SMs x 1.98 GHz
INT32_OPS = 64 * 132 * 1.98e9
NOW = 1_700_000_000.0
DAY = 86_400.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    """The least time for the work: bytes at the HBM rate or flops at
    ``rate`` (f32 outside the tensor cores unless given), the larger."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# one dependent global read from L2, by scripts/time_tile_routes.py's
# round_trip_ns (a one-thread pointer chase through 8 MiB) on an NVIDIA
# H100 80GB HBM3 at 700 W: the step of K10's and K2's latency bounds (the
# upper layers K10 walks, and a pool K2 scores back to back, sit in L2)
L2_READ_NS = 183.0


def latency_bound(bms: float, by: str, reads: int):
    """bound()'s (ms, reason), or ``reads`` dependent reads from L2 where
    that takes longer."""
    lat = reads * L2_READ_NS * 1e-6
    if lat <= bms:
        return bms, by
    return lat, (f"bytes (latency: {reads} dependent reads x {L2_READ_NS}"
                 f" ns from L2)")


def queued_us(torch, fn, calls: int = 20) -> float:
    """Device microseconds a call of ``fn`` takes back to back: CUDA events
    around ``calls`` calls queued behind a sleep of the card, so no host
    gap falls between them (torch.profiler's kernel records of these
    short calls came back incomplete at times on this card)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / calls


def k2_entry(torch, fu, results, key: str, x, q, pool, m: int) -> None:
    """K2 on (x, q, pool) at m against its plain version: the results
    entry ``key`` with its times (CUDA events back to back, device us by
    events behind a sleep, the wrapper's host us) beside its bound (bytes,
    or at B = 1 two dependent reads: the pool's ids, then its rows)."""
    vk, rk = fu.rerank_f32(x, q, pool, m)
    vp, rp = fu.rerank_f32_plain(x, q, pool, m)
    fin = torch.isfinite(vp)
    tol = 1e-5 * float(vp[fin].max()) if bool(fin.any()) else 0.0
    err, differ = topk_check(key, vk, rk, vp, rp, tol)
    valid = pool >= 0
    distinct = int(torch.unique(pool[valid]).numel())
    b, ov = pool.shape
    d = x.shape[1]
    bms, by = bound(distinct * d * x.element_size() + pool.numel() * 4
                    + b * d * 4 + b * m * 8, 3.0 * int(valid.sum()) * d)
    if b == 1:
        bms, by = latency_bound(bms, by, 2)

    def run():
        return fu.rerank_f32(x, q, pool, m)

    results[key] = dict(
        shape=f"B={b} OV={ov} m={m} D={d} distinct rows {distinct}"
              f"{' (bf16 rows)' if x.dtype == torch.bfloat16 else ''}",
        max_abs_err=err, tol=tol, rows_differing_at_ties=differ,
        ms=cuda_ms(torch, run, iters=20 if b == 1 else 5),
        device_us=queued_us(torch, run), host_us=host_us(torch, run),
        plain_ms=cuda_ms(torch, lambda: fu.rerank_f32_plain(x, q, pool, m),
                         iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by)


def k10_entry(torch, hn, results, key: str, gargs, shape: str) -> tuple:
    """K10 on gargs against its plain version (99% of walks equal): the
    results entry ``key`` with its times beside its bound, the larger of
    its bytes and its longest query's hop attempts x one dependent read.
    Returns its work (bytes, flops)."""
    ck, dk = hn.greedy_descent(*gargs)
    gst = {}
    cp, dp = hn.greedy_descent_plain(*gargs, stats=gst)
    same = ck == cp
    agree = float(same.float().mean())
    if agree < 0.99:
        fail(f"{key}: {agree} of queries agree with plain")
    x, q, m_up = gargs[0], gargs[5], int(gargs[3].shape[1])
    b, d = q.shape
    # bytes: each distinct row scored once, each hop's list; flops: every
    # (query, row) distance
    seen = int(gst["seen"].sum())
    work = (seen * (d * x.element_size() + 4) + gst["hops"] * m_up * 4
            + b * d * 4, gst["rows"] * 2.0 * d)
    bms, by = latency_bound(*bound(*work), gst["longest"])

    def run():
        return hn.greedy_descent(*gargs)

    results[key] = dict(
        shape=shape, max_abs_err=float((dk - dp)[same].abs().max()),
        agree=agree, hops=gst["hops"], longest=gst["longest"],
        rows=gst["rows"], distinct_rows=seen,
        ms=cuda_ms(torch, run, iters=20 if b == 1 else 5),
        device_us=queued_us(torch, run), host_us=host_us(torch, run),
        plain_ms=cuda_ms(torch, lambda: hn.greedy_descent_plain(*gargs),
                         iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by)
    return work


def cuda_ms(torch, fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def gemm_ms(torch, q, xb) -> float:
    """One bf16 ``torch.matmul`` of the rounded queries q [B, D] and the
    bf16 rows xb [N, D]^T: a yardstick of the tensor cores' rate at a tile
    pass's shape. The port never calls it, and it is no ``library_ms``: it
    computes the products only (no norms, mask or selection)."""
    qb = q.to(torch.bfloat16)
    return cuda_ms(torch, lambda: torch.matmul(qb, xb.T))


def device_us_each(torch, fns) -> list:
    """Device microseconds of each call of ``fns`` in turn, read by CUDA
    events while the card runs a sleep long enough for the host to queue
    every call, so no host gap falls between two events."""
    fns[0]()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
    torch.cuda._sleep(20_000_000)
    ev[0].record()
    for fn, e in zip(fns, ev[1:]):
        fn()
        e.record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) * 1e3 for i in range(len(fns))]


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (its launches
    queued, the card not waited for), over ``calls`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e6


def route_bound(nbytes: float, flops: float, route: str):
    """bound() at the rate of K1's route (ops.topk.tile_route): three TF32
    products ("tf32x3"), three bf16 products ("bf16x3"), one bf16 product
    ("wgmma"), f32 FMA ("fma"); ``flops`` counts one product's operations.
    The reason names the route."""
    rate, times, what = {
        "tf32x3": (TF32_FLOPS, 3, " (3 TF32 products)"),
        "bf16x3": (BF16_FLOPS, 3, " (3 bf16 products, tensor-core rate)"),
        "wgmma": (BF16_FLOPS, 1, " (bf16 tensor-core rate)"),
        "fma": (F32_FLOPS, 1, "")}[route]
    ms, by = bound(nbytes, times * flops, rate)
    return ms, by + what


def project_bound(n: int, d: int, r: int):
    """K14's projection bound: n rows of d bf16 in, r bf16 and a norm out,
    against its three bf16 products (P's exact split) at the tensor cores'
    rate."""
    return bound(n * (d * 2 + r * 2 + 4) + d * r * 4 + d * 4,
                 3 * 2.0 * n * d * r, BF16_FLOPS)


def off_center_share(torch, fu, blk, pm):
    """Equal share of K14's projection against its plain version on ``blk``
    moved off the origin by three times its rows' spread along a seeded
    direction, mu its mean: the case where x . P and mu . P cancel."""
    g = torch.Generator(device=blk.device).manual_seed(13)
    x = blk.float()
    spread = float((x - x.mean(0)).norm(dim=1).mean())
    v = torch.randn(x.shape[1], device=blk.device, generator=g)
    x = (x + 3.0 * spread * v / v.norm()).to(torch.bfloat16)
    mu = x.float().mean(0)
    n, r = x.shape[0], pm.shape[1]
    out_k = torch.empty((n, r), dtype=torch.bfloat16, device=blk.device)
    out_p, sq_k = torch.empty_like(out_k), torch.empty(n, device=blk.device)
    sq_p = torch.empty_like(sq_k)
    fu.project_rows(x, mu, pm, out_k, sq_k, 0)
    fu.project_rows_plain(x, mu, pm, out_p, sq_p, 0)
    return float((out_k.float() == out_p.float()).float().mean())


def topk_check(tag, vk, rk, vp, rp, tol):
    """Kernel top-k (vk, rk) against the plain one (vp, rp). The kernel's
    list comes out ascending. After sorting both by (distance, row), the
    distances agree within tol element by element. Where the rows of a
    query differ (a swap at a tie), a row in both lists has the same
    distance within tol in each, and a row in one list only must tie the
    k-th within tol. Returns (max_abs_err, queries differing)."""
    vk, rk, vp, rp = (t.cpu().numpy() for t in (vk, rk, vp, rp))
    what = tag
    fin = np.isfinite(vp)
    if not (np.isfinite(vk) == fin).all():
        fail(f"{what}: padding differs from the plain version")
    vkf = np.where(np.isfinite(vk), vk, np.inf)
    if (np.diff(vkf, axis=1) < 0).any():
        fail(f"{what}: the kernel's distances are not ascending")
    ok, op = np.lexsort((rk, vk)), np.lexsort((rp, vp))
    vk, rk = np.take_along_axis(vk, ok, 1), np.take_along_axis(rk, ok, 1)
    vp, rp = np.take_along_axis(vp, op, 1), np.take_along_axis(rp, op, 1)
    err = float(np.abs(np.where(fin, vk - vp, 0.0)).max())
    if err > tol:
        fail(f"{what}: max_abs_err {err} > {tol}")
    differ = 0
    for i in np.nonzero((rk != rp).any(1))[0]:
        differ += 1
        kth = vp[i][fin[i]].max()
        a, b = set(rk[i][rk[i] >= 0].tolist()), set(rp[i][rp[i] >= 0].tolist())
        dk, dp = dict(zip(rk[i].tolist(), vk[i])), dict(zip(rp[i].tolist(), vp[i]))
        for r in a & b:
            if abs(float(dk[r]) - float(dp[r])) > tol:
                fail(f"{what}: query {i} row {r} has another distance")
        for r in a ^ b:
            d = vp[i][rp[i] == r] if r in b else vk[i][rk[i] == r]
            if abs(float(d[0]) - kth) > tol:
                fail(f"{what}: query {i} row {r} differs off a tie")
    return err, differ


# the routes that the main path takes only where a shape falls off the
# tensor-core pass or a launch's survivors pass their buffer (K1 / K3 on the
# FMA pass, stage 1's dump route), each held to its plain version at a main
# path's shape; printed on a line of their own ("route_checks"), since the
# kernels line counts the main path's launches
ROUTE_CHECKS: dict = {}
# K2's, K6's, K10's and K11's launches by shape on each phase's main path
# (read where the phase reads its counts, before any check), so that a
# kernel's cost can be ordered by each shape's launches times that shape's
# time
SHAPE_LAUNCHES: dict = {}


def note_shapes(phase: str, native) -> None:
    SHAPE_LAUNCHES[phase] = {
        k: v for k, v in native.shape_launches.items()
        if v and k.split(" ")[0].startswith(("beam_search", "assign",
                                              "lloyd", "rerank",
                                              "greedy", "seed_",
                                              "kmeans_pp"))}


def kernels_phase(torch, tp, hn, km, dev, results):
    """Each kernel against its plain version at the main path's shapes."""
    g = torch.Generator(device=dev).manual_seed(0)
    n, d = 131_072, 384
    x = torch.randn(n, d, device=dev, generator=g)
    x_sq = (x * x).sum(1)
    mask = torch.rand(n, device=dev, generator=g) < 0.9
    n_in = int(mask.sum())

    # K1: search shape and link-candidate shape
    for tag, b, k in (("search", 128, 16), ("candidates", 1024, 200)):
        q = torch.randn(b, d, device=dev, generator=g)
        vk, rk = tp.l2_topk(x, x_sq, mask, q, k)
        vp, rp = tp.l2_topk_plain(x, x_sq, mask, q, k)
        torch.cuda.synchronize()
        tol = 2e-5 * float(x_sq.max() + (q * q).sum(1).max())
        err, differ = topk_check(f"l2_topk[{tag}]", vk, rk, vp, rp, tol)
        ms = cuda_ms(torch, lambda: tp.l2_topk(x, x_sq, mask, q, k))
        pms = cuda_ms(torch, lambda: tp.l2_topk_plain(x, x_sq, mask, q, k),
                      iters=3)
        # three TF32 products on the tensor-core route (tile_route), one
        # f32 product on the FMA pass (its bound beside)
        route = tp.tile_route(x.dtype, False, d)
        nbytes = n * d * 4 + n * 4 + n + b * d * 4 + b * k * 8
        bms, by = route_bound(nbytes, 2.0 * b * n_in * d, route)
        results[f"l2_topk[{tag}]"] = dict(
            shape=f"B={b} N={n} D={d} k={k} mask={n_in / n:.3f}",
            max_abs_err=err, tol=tol, rows_differing_at_ties=differ, ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, tile_pass=route,
            bound_fma_ms=bound(nbytes, 2.0 * b * n_in * d)[0])
        if tag == "candidates":
            cand_ids, cand_d = rk[:, :128].contiguous(), vk[:, :128].contiguous()

    # K4: the link pool (C=128, m=32) and the reverse prune (C=64, m=32)
    for tag, c in (("link", 128), ("prune", 64)):
        ids = cand_ids[:, :c].contiguous()
        dd = cand_d[:, :c].contiguous()
        if tag == "prune":  # the prune's tables carry -1 / +inf padding
            ids[:, -8:] = -1
            dd[:, -8:] = float("inf")
        kk = hn.heuristic_kept(x, ids, dd, 32)
        kp = hn.heuristic_kept_plain(x, ids, dd, 32)
        torch.cuda.synchronize()
        flips = k4_flips(f"heuristic_kept[{tag}]", kk, kp, ids, dd, x, False)
        ms = cuda_ms(torch, lambda: hn.heuristic_kept(x, ids, dd, 32))
        pms = cuda_ms(torch, lambda: hn.heuristic_kept_plain(x, ids, dd, 32),
                      iters=3)
        results[f"heuristic_kept[{tag}]"] = dict(
            shape=f"B={ids.shape[0]} C={c} D={d} m=32",
            max_abs_err=float((kk != kp).any().item()),
            rows_differing_at_ties=flips, ms=ms, plain_ms=pms,
            **k4_bound(hn, x, ids))
    k4_fma_checks(torch, hn, x, cand_ids, cand_d)

    # K5: reverse-prune pair distances
    p = 65_536
    t_ids = torch.randint(0, n, (p,), device=dev, generator=g,
                          dtype=torch.int32)
    c_ids = torch.randint(0, n, (p,), device=dev, generator=g,
                          dtype=torch.int32)
    ok = hn.pair_sq_l2(x, x_sq, t_ids, c_ids)
    op = hn.pair_sq_l2_plain(x, x_sq, t_ids, c_ids)
    err = float((ok - op).abs().max())
    tol = 2e-5 * float(2 * x_sq.max())
    if err > tol:
        fail(f"pair_sq_l2: max_abs_err {err} > {tol}")
    bms, by = bound(p * (2 * d * 4 + 8 + 8 + 4), p * 2.0 * d)
    results["pair_sq_l2"] = dict(
        shape=f"P={p} D={d}", max_abs_err=err, tol=tol,
        ms=cuda_ms(torch, lambda: hn.pair_sq_l2(x, x_sq, t_ids, c_ids)),
        plain_ms=cuda_ms(torch,
                         lambda: hn.pair_sq_l2_plain(x, x_sq, t_ids, c_ids)),
        bound_ms=bms, bound_by=by)

    # K6: IVF-sized Lloyd block and the session's 10-row x 3-cluster train
    from fabstir_vectordb_tpu_torch.utils import native

    rng = np.random.default_rng(1)
    for tag, nn, cc, valid in (("65536x256", 65_536, 256, 65_536),
                               ("session", 16, 3, 10)):
        centers = rng.standard_normal((cc, d)).astype(np.float32) * 4
        xs = centers[rng.integers(0, cc, nn)] \
            + rng.standard_normal((nn, d)).astype(np.float32)
        xt = torch.from_numpy(xs).to(dev)
        mk = torch.arange(nn, device=dev) < valid
        init = xt[torch.from_numpy(rng.choice(valid, cc, replace=False))
                  .to(dev)].contiguous()
        # K6's tensor-core route at 256 lists, its FMA tile at 3
        fma = km.lloyd_route(nn, cc, d) == "fma"
        sfx = "_fma" if fma else ""
        before = {k: native.launches[k + sfx]
                  for k in ("lloyd_block", "assign_clusters")}
        ck, ek = km.lloyd_block(xt, mk, init, 5)
        cp, ep = km.lloyd_block_plain(xt, mk, init, 5)
        ak, _ = km.assign_clusters(xt, init, mk)
        ap, _ = km.assign_clusters_plain(xt, init, mk)
        torch.cuda.synchronize()
        if any(native.launches[k + sfx] != v + 1 for k, v in before.items()):
            fail(f"lloyd_block[{tag}]: not on the {'FMA' if fma else 'tensor-core'}"
                 f" route")
        err = float((ck - cp).abs().max())
        scale = float(xt.abs().max())
        tol = 1e-5 * scale
        if err > tol or not torch.allclose(ek, ep, rtol=1e-4, atol=1e-3):
            fail(f"lloyd_block[{tag}]: centroids off by {err} (tol {tol}), "
                 f"errors {ek.tolist()} vs {ep.tolist()}")
        if not bool((ak == ap).all()):
            fail(f"assign_clusters[{tag}]: assignments differ")
        steps = 5
        # the tensor-core route's bound: three TF32 products
        bms, by = bound(steps * (nn * d * 4 + 2 * cc * d * 4) + nn,
                        steps * 2.0 * valid * cc * d * (1 if fma else 3),
                        F32_FLOPS if fma else TF32_FLOPS)
        results[f"lloyd_block{sfx}[{tag}]"] = dict(
            shape=f"N={nn} (valid {valid}) C={cc} D={d} steps={steps}",
            max_abs_err=err, tol=tol,
            ms=cuda_ms(torch, lambda: km.lloyd_block(xt, mk, init, 5)),
            plain_ms=cuda_ms(torch,
                             lambda: km.lloyd_block_plain(xt, mk, init, 5)),
            bound_ms=bms, bound_by=by)
        if fma:  # the flat tier's assignment would take this tile too
            bms, by = bound(nn * d * 4 + cc * d * 4 + nn * 9,
                            2.0 * nn * cc * d)
            ROUTE_CHECKS[f"assign_clusters_fma[{tag}]"] = dict(
                shape=f"N={nn} (valid {valid}) C={cc} D={d}",
                max_abs_err=float((km.assign_clusters(xt, init, mk)[1]
                                   - km.assign_clusters_plain(
                                       xt, init, mk)[1]).abs().max()),
                ms=cuda_ms(torch, lambda: km.assign_clusters(xt, init, mk)),
                plain_ms=cuda_ms(torch, lambda: km.assign_clusters_plain(
                    xt, init, mk)),
                bound_ms=bms, bound_by=by)
    fma_checks(torch, tp, x, x_sq, mask, g)
    b1_b4_checks(torch, tp, hn, km, dev, results)
    for name, r in results.items():
        print(f"kernel {name}: agree=True library_ms={r.get('library_ms')} "
              + " ".join(f"{k}={v}" for k, v in r.items()
                         if k != "library_ms"), flush=True)


# K4's route (index.hnsw.heuristic_route) as route_bound names it: three
# TF32 products, one bf16 product, f32 FMA
K4_RATE = {"tf32x3": "tf32x3", "bf16": "wgmma", "fma": "fma"}


def k4_bound(hn, x, ids) -> dict:
    """K4's pass and its bound: the gathered rows, the ids and distances in
    and the flags out, against the Gram products over the triangle on and
    above the diagonal at the rate of its route (and of f32 FMA)."""
    b, c = ids.shape
    d = x.shape[1]
    route = hn.heuristic_route(x)
    nbytes = int((ids >= 0).sum()) * d * x.element_size() + b * c * 9
    flops = b * c * (c + 1) / 2 * 2.0 * d
    bms, by = route_bound(nbytes, flops, K4_RATE[route])
    return dict(bound_ms=bms, bound_by=by, tile_pass=route,
                bound_fma_ms=bound(nbytes, flops)[0])


def k4_fma_checks(torch, hn, x, cand_ids, cand_d):
    """K4 on its FMA route (rows cp.async cannot copy 16 bytes at a time:
    here 4 or 2 bytes off a 16-byte boundary), on f32 and on bf16 rows, at
    the link shape ("heuristic_kept_fma", "heuristic_kept_bf16_fma")."""
    from fabstir_vectordb_tpu_torch.utils import native

    n, d = x.shape
    for dt in (torch.float32, torch.bfloat16):
        xa = x.to(dt)
        xu = torch.empty(n * d + 1, dtype=dt, device=x.device)[1:].view(n, d)
        xu.copy_(xa)
        name = native.counter("heuristic_kept", dt == torch.bfloat16,
                              fma=True)
        before = native.launches[name]
        kk = hn.heuristic_kept(xu, cand_ids, cand_d, 32)
        launched = native.launches[name] - before
        if launched != 1:
            fail(f"{name}: {launched} launches of the FMA route")
        kp = hn.heuristic_kept_plain(xa, cand_ids, cand_d, 32)
        torch.cuda.synchronize()
        flips = k4_flips(f"{name}[link]", kk, kp, cand_ids, cand_d, xa,
                         dt == torch.bfloat16)
        ROUTE_CHECKS[f"{name}[link]"] = dict(
            shape=f"B={cand_ids.shape[0]} C={cand_ids.shape[1]} D={d} m=32 "
                  f"{'bf16' if dt == torch.bfloat16 else 'f32'} rows off 16",
            launches_in_check=launched,
            max_abs_err=float((kk != kp).any().item()),
            rows_differing_at_ties=flips,
            ms=cuda_ms(torch, lambda: hn.heuristic_kept(
                xu, cand_ids, cand_d, 32)),  # noqa: B023
            **{k: v for k, v in k4_bound(hn, xu, cand_ids).items()
               if k in ("bound_ms", "bound_by")})
        del xu, xa


def k4_flips(tag, kk, kp, ids, dd, x, bf16: bool) -> int:
    """Queries whose K4 flags differ from the plain version's; each one's
    first flip must sit at a near-tie of the plain scan: within 1e-5 of
    the query distance on f32 rows, of twice the largest squared norm of
    the pool on bf16 rows (both sides sum the Gram expansion in f32: a tie
    is within 1e-5 of the norms it cancels)."""
    rows = (kk != kp).any(1).nonzero().flatten().tolist()
    for r in rows:
        i = int((kk[r] != kp[r]).nonzero()[0])
        v = x[ids[r].clamp_min(0).long()].double()
        before = kp[r, :i].nonzero().flatten()
        pd = ((v[i] - v[before]) ** 2).sum(-1)
        dmin = float(pd.min()) if pd.numel() else float("inf")
        tol = 1e-5 * (2.0 * float((v * v).sum(-1).max()) if bf16
                      else float(dd[r, i]))
        if abs(float(dd[r, i]) - dmin) > tol:
            fail(f"{tag}: row {r} differs off a tie ({float(dd[r, i])} "
                 f"against {dmin}, tol {tol})")
    return len(rows)


def fma_checks(torch, tp, x, x_sq, mask, g):
    """K1 and K3 on f32 rows on l2_tile.cuh's FMA pass, the route of rows
    that TMA cannot read in place (here 4 bytes off a 16-byte boundary) and
    of odd D, at the search and link-candidate shapes ("l2_topk_fma")."""
    from fabstir_vectordb_tpu_torch.utils import native

    n, d = x.shape
    xu = torch.empty(n * d + 1, device=x.device)[1:].view(n, d)
    xu.copy_(x)
    n_in = int(mask.sum())
    for tag, b, k in (("search", 128, 16), ("candidates", 1024, 200)):
        q = torch.randn(b, d, device=x.device, generator=g)
        before = native.launches["l2_topk_fma"]
        vk, rk = tp.l2_topk(xu, x_sq, mask, q, k)
        launched = native.launches["l2_topk_fma"] - before
        if launched != 1:
            fail(f"l2_topk_fma[{tag}]: {launched} launches of the FMA pass")
        vp, rp = tp.l2_topk_plain(x, x_sq, mask, q, k)
        tol = 2e-5 * float(x_sq.max() + (q * q).sum(1).max())
        err, differ = topk_check(f"l2_topk_fma[{tag}]", vk, rk, vp, rp, tol)
        nbytes = n * d * 4 + n * 4 + n + b * d * 4 + b * k * 8
        bms, by = bound(nbytes, 2.0 * b * n_in * d)
        ROUTE_CHECKS[f"l2_topk_fma[{tag}]"] = dict(
            shape=f"B={b} N={n} D={d} k={k} rows 4 bytes off 16",
            launches_in_check=launched, max_abs_err=err, tol=tol,
            rows_differing_at_ties=differ,
            ms=cuda_ms(torch, lambda: tp.l2_topk(xu, x_sq, mask, q, k)),
            bound_ms=bms, bound_by=by)
    del xu


def b1_b4_checks(torch, tp, hn, km, dev, results):
    """B1-B4 against their plain versions at the shapes of their paths: the
    pipelined build's member scatter (a 1M mask, 1,024 rows), one Lloyd
    step at K6's IVF training shape, the exact and binned top-k of a
    [128, 1M] distance matrix."""
    g = torch.Generator(device=dev).manual_seed(3)
    n = 1_048_576
    # B1: set_member_rows, library index_put_
    mask = torch.rand(n, device=dev, generator=g) < 0.1
    rows = torch.randint(0, n, (1_024,), device=dev, generator=g,
                         dtype=torch.int32)
    want = hn.set_member_rows_plain(mask.clone(), rows)
    got = hn.set_member_rows(mask.clone(), rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("set_member_rows: differs from its plain version")
    rows_l = rows.long()
    bms, by = bound(1_024 * 4 + 1_024, 0.0)
    results["set_member_rows"] = dict(
        shape=f"N={n} rows=1024", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: hn.set_member_rows(mask, rows), iters=20),
        plain_ms=cuda_ms(torch, lambda: hn.set_member_rows_plain(mask, rows),
                         iters=20),
        library_ms=cuda_ms(torch, lambda: mask.index_put_(
            (rows_l,), torch.tensor(True, device=dev)), iters=20),
        bound_ms=bms, bound_by=by)

    # B2: lloyd_step at K6's IVF training shape; error within 1% either
    # way, centroids within 1e-5 max|x| (K6's atomic order)
    rng = np.random.default_rng(4)
    nn, cc, d = 65_536, 256, 384
    centers = rng.standard_normal((cc, d)).astype(np.float32) * 4
    lab = rng.integers(0, cc, nn)
    xs = centers[lab] + rng.standard_normal((nn, d)).astype(np.float32)
    xt = torch.from_numpy(xs).to(dev)
    mk = torch.rand(nn, device=dev, generator=g) < 0.95
    # one starting centroid a cluster: two in one tight cluster make its
    # bisector rows near-ties that f32 sums in another order split
    # differently (ROADMAP C, "Atomics")
    first = np.array([np.flatnonzero(lab == c)[0] for c in range(cc)])
    init = xt[torch.from_numpy(first).to(dev)].contiguous()
    ck, ek = km.lloyd_step(xt, mk, init)
    cp, ep = km.lloyd_step_plain(xt, mk, init)
    torch.cuda.synchronize()
    err = float((ck - cp).abs().max())
    tol = 1e-5 * float(xt.abs().max())
    if err > tol or abs(float(ek) - float(ep)) > 0.01 * float(ep):
        fail(f"lloyd_step: centroids off by {err} (tol {tol}), error "
             f"{float(ek)} vs {float(ep)}")
    valid = int(mk.sum())
    bms, by = bound(nn * d * 4 + nn + 2 * cc * d * 4,
                    lloyd_work(valid, d, cc, 1)[1])
    results["lloyd_step"] = dict(
        shape=f"N={nn} (valid {valid}) C={cc} D={d}", max_abs_err=err,
        tol=tol, error_rel_diff=abs(float(ek) - float(ep)) / float(ep),
        ms=cuda_ms(torch, lambda: km.lloyd_step(xt, mk, init)),
        plain_ms=cuda_ms(torch, lambda: km.lloyd_step_plain(xt, mk, init)),
        library_ms=None, bound_ms=bms, bound_by=by)
    del xt, mk, init, ck, cp

    # B3 / B4 over a [128, 1M] matrix of distances (a query batch against
    # the 1M tier's row count), 90% of the rows masked in
    b = 128
    dm = torch.rand(b, n, device=dev, generator=g) * 100.0
    rmask = torch.rand(n, device=dev, generator=g) < 0.9
    qmask = torch.rand(b, n, device=dev, generator=g) < 0.9
    for tag, dd, mm, k in (("k=16", dm, rmask, 16), ("k=1024", dm, rmask,
                                                       1_024),
                           ("k=1024 BxN mask", dm, qmask, 1_024),
                           ("k>N", dm[:, :1_000].contiguous(), None, 1_500)):
        vk, rk = tp.masked_topk(dd, mm, k)
        vp, rp = tp.masked_topk_plain(dd, mm, k)
        torch.cuda.synchronize()
        if not (torch.equal(rk, rp) and torch.equal(vk, vp)):
            fail(f"masked_topk[{tag}]: differs from its plain version")
        src = torch.where(mm, dd, torch.full_like(dd, float("inf"))) \
            if mm is not None else dd
        kl = min(k, dd.shape[1])
        bms, by = bound(dd.numel() * 4 + (mm.numel() if mm is not None
                                          else 0) + b * k * 8, 0.0)
        results[f"masked_topk[{tag}]"] = dict(
            shape=f"B={b} N={dd.shape[1]} k={k}"
                  + (f" mask=0.9 {list(mm.shape)}" if mm is not None
                     else ""),
            max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: tp.masked_topk(dd, mm, k), iters=20),
            plain_ms=cuda_ms(torch, lambda: tp.masked_topk_plain(dd, mm, k),
                             iters=3),
            library_ms=cuda_ms(torch, lambda: torch.topk(
                src, kl, dim=1, largest=False, sorted=True), iters=20),
            device_us=min(device_us_each(
                torch, [lambda: tp.masked_topk(dd, mm, k)] * 10)),
            bound_ms=bms, bound_by=by)
        del src
    del qmask
    k = 128
    vk, rk = tp.masked_approx_topk(dm, rmask, k)
    vp, rp = tp.masked_approx_topk_plain(dm, rmask, k)
    torch.cuda.synchronize()
    ov = overlap(rk.cpu().numpy(), rp.cpu().numpy())
    if ov < 0.99:
        fail(f"masked_approx_topk: overlap {ov} with its plain version")
    both = (rk == rp) & (rk >= 0)
    err = float((vk - vp)[both].abs().max())
    bms, by = bound(dm.numel() * 4 + n + b * k * 8, 0.0)
    results["masked_approx_topk"] = dict(
        shape=f"B={b} N={n} k={k} bins={tp.approx_bins(n, k)} mask=0.9",
        max_abs_err=err, overlap=ov,
        ms=cuda_ms(torch, lambda: tp.masked_approx_topk(dm, rmask, k)),
        plain_ms=cuda_ms(torch,
                         lambda: tp.masked_approx_topk_plain(dm, rmask, k),
                         iters=3),
        library_ms=None, bound_ms=bms, bound_by=by)
    del dm, vk, rk, vp, rp


def make_corpus(n: int, d: int, seed: int):
    """Gaussian mixture: 1,000 centers, unit noise around centers of scale
    2, so HNSW linking sees real local structure."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1000, d)).astype(np.float32) * 2.0
    lab = rng.integers(0, 1000, n)
    x = centers[lab]
    x += rng.standard_normal((n, d), dtype=np.float32)
    return x, lab


class Oracle:
    """Exact float64 brute force over the live rows, on the host."""

    def __init__(self, x):
        self.x = x.astype(np.float64)
        self.sq = (self.x ** 2).sum(1)
        self.live = np.ones(len(x), bool)

    def check(self, q, got, k, allow=None, what=""):
        """got: session results for query q. Rows equal up to ties, distances
        within 1e-4 relative."""
        q = np.asarray(q, np.float64)
        d = np.maximum(self.sq - 2.0 * (self.x @ q) + q @ q, 0.0)
        ok = self.live if allow is None else (self.live & allow)
        d = np.where(ok, np.sqrt(d), np.inf)
        kth = np.partition(d, k - 1)[k - 1]
        ids = [int(r["id"][4:]) for r in got]
        dist = np.array([1.0 / r["score"] - 1.0 for r in got])
        if len(ids) != min(k, int(ok.sum())):
            fail(f"{what}: {len(ids)} results, expected {k}")
        if not ok[ids].all():
            fail(f"{what}: a deleted or filtered-out row was returned")
        if not np.allclose(dist, d[ids], rtol=1e-4, atol=1e-4):
            fail(f"{what}: distances off: {dist} vs {d[ids]}")
        if (d[ids] > kth * (1 + 1e-4)).any():
            fail(f"{what}: a returned row is not in the exact top-{k}")
        must = np.nonzero(d < kth * (1 - 1e-4))[0]
        if not set(must.tolist()) <= set(ids):
            fail(f"{what}: an exact top-{k} row is missing")


@contextlib.contextmanager
def profiled(prof, name: str):
    """cProfile the block into prof[name] when prof is a dict."""
    if prof is None:
        yield
        return
    import cProfile

    p = cProfile.Profile()
    p.enable()
    try:
        yield
    finally:
        p.disable()
        prof[name] = p


def device_trace(torch, name: str, fn, out_dir: str):
    """Run fn under torch.profiler; write the ops by device time to
    <out_dir>/trace_<name>.txt. Returns (wall ms, device ms): the device
    time is the sum of every kernel's and copy's own time on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = p.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    device = sum(dev_us(e) for e in events) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"trace_{name}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=25))
    return wall, device


def main_path(torch, native, card: str, counts: dict, perf: dict,
              prof=None, trace=False, out_dir="smoke_out"):
    from fabstir_vectordb_tpu_torch import VectorDBSession

    n, d = CORPUS_ROWS, 384
    x, lab = make_corpus(n, d, seed=7)
    oracle = Oracle(x)
    rng = np.random.default_rng(11)
    s = VectorDBSession.create({"sessionId": "chip-smoke"}, device=None)
    if s.device.type != "cuda":
        fail("the session did not land on the card")

    native.reset_launches()
    t0 = time.perf_counter()
    batch = 10_000
    with profiled(prof, "ingest"):
        for lo in range(0, n, batch):
            s.add_vectors([{"id": f"doc-{i}", "vector": x[i],
                            "metadata": {"cat": int(i % 10),
                                         "cluster": int(lab[i])}}
                           for i in range(lo, min(n, lo + batch))])
        torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    counts["l2_topk[candidates]"] = native.launches["l2_topk"]
    st = s.get_stats()
    if st.vector_count != n or st.hnsw_vector_count != n:
        fail(f"ingest: stats {st.to_json()}")
    print(f"main: ingested {n} x {d} in {ingest_s:.3f} s: "
          f"{n / ingest_s:.1f} vectors/s ({card}); graph "
          f"{s.index.hnsw.graph_stats()}", flush=True)

    def query(i):  # a point near a stored row, off the row itself
        return (x[i] + 0.3 * rng.standard_normal(d)).astype(np.float32)

    k = 10
    lat = []
    singles = rng.integers(0, n, 256)
    qs = [query(i) for i in singles]
    qb = np.stack([query(i) for i in rng.integers(0, n, 8 * 128)])
    with profiled(prof, "search"):
        got = []
        for q in qs:
            t = time.perf_counter()
            got.append(s.search(q, k))
            lat.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        outs = [s.search_batch(qb[b * 128:(b + 1) * 128], k)
                for b in range(8)]
        batch_s = time.perf_counter() - t
    for j, (q, res) in enumerate(zip(qs, got)):
        oracle.check(q, res, k, what=f"single search {j}")
    for b, out in enumerate(outs):
        for i, res in enumerate(out):
            oracle.check(qb[b * 128 + i], res, k, what=f"batch {b} query {i}")
    qf = query(int(singles[0]))
    res = s.search(qf, k, {"filter": {"cat": 3}})
    oracle.check(qf, res, k, allow=(np.arange(n) % 10 == 3),
                 what="filtered search")
    if not all(r["metadata"]["cat"] == 3 for r in res):
        fail("filtered search returned another category")

    # delete 1,000 ids, among them the top results of the first queries
    top = [r["id"] for i in singles[:50] for r in s.search(query(i), 5)]
    dead = list(dict.fromkeys(top + [f"doc-{i}" for i in
                                     rng.choice(n, 1000, replace=False)]))[:1000]
    for vid in dead:
        s.delete_vector(vid)
        oracle.live[int(vid[4:])] = False
    dead_set = set(dead)
    for j, i in enumerate(singles[:64]):
        q = query(i)
        res = s.search(q, k)
        oracle.check(q, res, k, what=f"search after deletes {j}")
        if dead_set & {r["id"] for r in res}:
            fail("a deleted id was returned")
    out = s.search_batch(qb[:128], k)
    for i, res in enumerate(out):
        oracle.check(qb[i], res, k, what=f"batch after deletes {i}")
        if dead_set & {r["id"] for r in res}:
            fail("a deleted id was returned by a batch")
    torch.cuda.synchronize()
    counts["l2_topk[search]"] = (native.launches["l2_topk"]
                                 - counts["l2_topk[candidates]"])
    # K6 at the flat tier's 3 lists: its FMA tile (ops.kmeans.lloyd_route)
    for name in ("heuristic_kept", "pair_sq_l2", "lloyd_block_fma"):
        counts[name] = native.launches[name]
    note_shapes("flat-100K", native)
    for name, c in counts.items():
        if c <= 0:
            fail(f"main path: {name} was launched no time")
    # "l2_topk" counts K1 on the tensor cores (three TF32 products); the
    # FMA pass takes f32 rows only at a D that TMA cannot read
    perf["l2_topk_fma_launches"] = native.launches["l2_topk_fma"]
    # "heuristic_kept" counts K4 on the tensor cores; its FMA route takes
    # rows that cp.async cannot copy 16 bytes at a time
    perf["heuristic_kept_fma_launches"] = native.launches["heuristic_kept_fma"]
    # K6's tensor-core route takes no shape of the flat tier (3 lists)
    perf["lloyd_tc_launches_flat"] = sum(
        native.launches[k] for k in ("lloyd_block", "assign_clusters"))
    if trace:  # device busy share of the two search shapes
        for name, fn in (
                ("single", lambda: [s.search(q, k) for q in qs[:64]]),
                ("batched", lambda: [s.search_batch(qb[b * 128:(b + 1) * 128],
                                                    k) for b in range(4)])):
            wall, dev_ms = device_trace(torch, name, fn, out_dir)
            print(f"trace {name}: wall {wall:.3f} ms, device {dev_ms:.3f} ms, "
                  f"busy share {dev_ms / wall:.3f} ({card})", flush=True)
    p50 = float(np.percentile(lat, 50))
    qps = 8 * 128 / batch_s
    # the search launch alone, on the path's own device state (these
    # launches come after the counts above were read)
    from fabstir_vectordb_tpu_torch.ops.topk import l2_topk

    st_dev = s.index.fused._device_state()
    kern = {}
    for b in (1, 128):
        qd = torch.from_numpy(qb[:b]).to(st_dev["x"].device)
        kern[b] = cuda_ms(torch, lambda: l2_topk(
            st_dev["x"], st_dev["x_sq"], st_dev["members"], qd, 16), iters=20)
    perf.update(ingest_vectors_per_s=n / ingest_s, search_p50_ms=p50,
                batched_qps=qps, corpus=n, search_kernel_ms_b1=kern[1],
                search_kernel_ms_b128=kern[128])
    print(f"main: search p50 {p50:.3f} ms over 256 single k=10 searches "
          f"({card})", flush=True)
    print(f"main: batched {qps:.1f} QPS over 8 batches of 128, k=10 ({card})",
          flush=True)
    print(f"main: the search kernel alone: {kern[1]:.4f} ms at B=1, "
          f"{kern[128]:.4f} ms at B=128 ({card})", flush=True)
    print(f"main: launches {counts}", flush=True)
    print("main: every answer matched the float64 brute force", flush=True)
    s.destroy()


def bench_corpus(n: int, d: int, seed: int):
    """bench.py's build_index data: 1,024 standard-normal centers, rows
    0.35-scaled standard normal noise around them (f32, one generator)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, d), dtype=np.float32)
    assign = rng.integers(0, 1024, n)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= 0.35
    x += centers[assign]
    return x, centers


def overlap(a, b) -> float:
    """Mean share of each row's valid ids of b that a holds too."""
    a, b = np.asarray(a), np.asarray(b)
    out = []
    for ra, rb in zip(a, b):
        sb = set(rb[rb >= 0].tolist())
        out.append(len(sb & set(ra[ra >= 0].tolist())) / max(len(sb), 1))
    return float(np.mean(out))


def recall(got, exact, k: int = 10) -> float:
    """recall@k of got [B, >=k] against exact [B, >=k] (rows)."""
    got, exact = np.asarray(got)[:, :k], np.asarray(exact)[:, :k]
    hits = [len(set(g[g >= 0].tolist()) & set(e[e >= 0].tolist()))
            for g, e in zip(got, exact)]
    return float(np.sum(hits) / max(int((exact >= 0).sum()), 1))


def build_1m(torch, native, card: str, perf: dict, launch_of: dict):
    """bench.py's 1M index (build_index) through HybridIndex.insert_batch:
    IVF training (K7 seeding, K6 Lloyd) and the HNSW linking of the recent
    rows. The launch counters start at 0 here; K7's are read at the end."""
    from fabstir_vectordb_tpu_torch.index.hybrid import (
        HybridConfig, HybridIndex, SearchConfig)
    from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig
    from fabstir_vectordb_tpu_torch.ops import kmeans as km

    n, d = PRUNED_ROWS, 384
    n_recent = n // 10
    t0 = time.perf_counter()
    x, centers = bench_corpus(n, d, seed=0)
    print(f"1M: corpus {n} x {d} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    h = HybridIndex(d, HybridConfig(
        ivf=IVFConfig(n_clusters=256, n_probe=16, train_size=10_000, seed=0),
        auto_migrate=False), device=None)
    native.reset_launches()
    # K7 (kmeans|| seeding) is timed inside the training: the whole seeding
    # and its host part, the weighted k-means++ over the candidates
    k7 = {"host": 0.0}
    seeding, host_pp = km.kmeans_scalable_init, km._weighted_kmeanspp_host

    def timed_seeding(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = seeding(*a, **kw)
        torch.cuda.synchronize()
        k7["s"] = time.perf_counter() - t
        return out

    def timed_host(*a, **kw):
        t = time.perf_counter()
        out = host_pp(*a, **kw)
        k7["host"] += time.perf_counter() - t
        return out

    km.kmeans_scalable_init, km._weighted_kmeanspp_host = (timed_seeding,
                                                            timed_host)
    try:
        t = time.perf_counter()
        h.initialize(x[:10_000])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
    finally:
        km.kmeans_scalable_init, km._weighted_kmeanspp_host = (seeding,
                                                                host_pp)
    k7_names = ("seed_pick", "seed_min_update_fma", "seed_min_update",
                "seed_counts")
    for name in k7_names:
        launch_of[name] = native.launches[name]
        if launch_of[name] <= 0:
            fail(f"IVF training: K7's {name} was launched no time")
    ts = np.full(n, NOW - 30 * DAY)
    ts[:n_recent] = NOW - DAY
    t = time.perf_counter()
    h.insert_batch([f"v{i}" for i in range(n)], x, ts, now=NOW)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t
    if h.hnsw.num_nodes != n_recent or h.ivf.active_count != n - n_recent:
        fail(f"1M: {h.hnsw.num_nodes} HNSW / {h.ivf.active_count} IVF")
    lens = np.bincount(h.ivf.assignments[h.ivf.assignments >= 0],
                       minlength=256)
    k7_ms, k7_host_ms = k7["s"] * 1e3, k7["host"] * 1e3
    print(f"1M: IVF trained in {train_s:.3f} s, K7 (kmeans|| seeding) "
          f"{k7_ms:.3f} ms: device part {k7_ms - k7_host_ms:.3f} ms, host "
          f"k-means++ {k7_host_ms:.3f} ms; K7 launches "
          f"{[launch_of[k] for k in k7_names]}"
          f"; inserted {n} rows ({n_recent} HNSW) in {ingest_s:.3f} s: "
          f"{n / ingest_s:.1f} vectors/s; lists {lens.min()}-{lens.max()} "
          f"rows, L_pad {h.ivf.tiles().shape[1]} ({card})", flush=True)
    perf.update(pruned_ingest_vectors_per_s=n / ingest_s,
                pruned_train_s=train_s, k7_seeding_ms=k7_ms,
                k7_host_kmeanspp_ms=k7_host_ms)
    return {"h": h, "x": x, "centers": centers, "n": n, "d": d,
            "n_recent": n_recent, "cfg": SearchConfig(auto_migrate=False),
            "rng": np.random.default_rng(5)}


def k7_checks(torch, ctx, results: dict) -> None:
    """K7's kmeans|| kernels against their plain versions at the IVF
    training shape (the first 10,000 rows, l = 409, 2,046 candidates): the
    pick, the table update and the counts on K6's tile pass, the first
    one-candidate update on the FMA route; the counts' FMA route (C = 63)
    on the route_checks line."""
    from fabstir_vectordb_tpu_torch.ops import kmeans as km

    d = ctx["d"]
    dev = ctx["h"].store.torch_device
    x = torch.from_numpy(ctx["x"][:10_000]).to(dev)
    n = x.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    first = km.seed_pick_plain(None, mask, torch.rand(n, device=dev,
                                                      generator=g), 1, False)
    inf = torch.full((n,), float("inf"), device=dev)
    x_sq_max = float((x * x).sum(1).max())
    tol = 2e-5 * 2 * x_sq_max
    d1k = km.seed_min_update(x, mask, inf, first)
    d2 = km.seed_min_update_plain(x, mask, inf, first)
    err = float((d1k - d2).abs().max())
    if err > tol:
        fail(f"seed_min_update_fma: max_abs_err {err} > {tol}")
    results["seed_min_update_fma"] = dict(
        shape=f"N={n} D={d} C=1", max_abs_err=err, tol=tol,
        ms=cuda_ms(torch, lambda: km.seed_min_update(x, mask, inf, first)),
        plain_ms=cuda_ms(torch, lambda: km.seed_min_update_plain(
            x, mask, inf, first)), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n * d * 4 + n * 9 + 4, 2.0 * n * d))))
    u = torch.rand(n, device=dev, generator=g)
    l, c_all = 409, 2046
    rk = km.seed_pick(d2, mask, u, l)
    rp = km.seed_pick_plain(d2, mask, u, l)
    if not torch.equal(rk, rp):
        fail("seed_pick: the picked rows differ from the plain version's")
    results["seed_pick"] = dict(
        shape=f"N={n} l={l}", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: km.seed_pick(d2, mask, u, l)),
        plain_ms=cuda_ms(torch, lambda: km.seed_pick_plain(d2, mask, u, l)),
        library_ms=None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n * (4 + 1 + 4) + l * 4, 4.0 * n))))
    # the tile pass: three TF32 products, as the f32 operations that take
    # as long at bound()'s f32 rate
    tc = 3 * F32_FLOPS / TF32_FLOPS
    dk = km.seed_min_update(x, mask, d2, rk)
    dp = km.seed_min_update_plain(x, mask, d2, rk)
    err = float((dk - dp).abs().max())
    if err > tol:
        fail(f"seed_min_update: max_abs_err {err} > {tol}")
    results["seed_min_update"] = dict(
        shape=f"N={n} D={d} l={l}", max_abs_err=err, tol=tol,
        ms=cuda_ms(torch, lambda: km.seed_min_update(x, mask, d2, rk)),
        plain_ms=cuda_ms(torch, lambda: km.seed_min_update_plain(
            x, mask, d2, rk)), library_ms=None,
        bound_fma_ms=bound(0, 2.0 * l * n * d)[0],
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n * d * 4 + n * 9 + l * 4, 2.0 * l * n * d * tc))))
    cand = torch.cat([first, rk] + [km.seed_pick_plain(
        dp, mask, torch.rand(n, device=dev, generator=g), l)
        for _ in range(4)])[:c_all].contiguous()

    def counts_agree(name, cand):
        ck = km.seed_counts(x, mask, cand)
        cp = km.seed_counts_plain(x, mask, cand)
        agree = float((ck == cp).float().mean())
        moved = int((ck - cp).abs().sum()) // 2
        if int(ck.sum()) != n or agree < 0.99 or moved > 0.001 * n:
            fail(f"{name}: {agree} of counts agree, {moved} rows moved, "
                 f"sum {int(ck.sum())}")
        return dict(max_abs_err=float((ck - cp).abs().max()), agree=agree,
                    rows_moved=moved)

    c = cand.shape[0]
    results["seed_counts"] = dict(
        shape=f"N={n} D={d} C={c}", **counts_agree("seed_counts", cand),
        ms=cuda_ms(torch, lambda: km.seed_counts(x, mask, cand)),
        plain_ms=cuda_ms(torch, lambda: km.seed_counts_plain(x, mask, cand)),
        library_ms=None, bound_fma_ms=bound(0, 2.0 * c * n * d)[0],
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n * d * 4 + n + c * 8, 2.0 * c * n * d * tc))))
    few = cand[:63].contiguous()
    ROUTE_CHECKS["seed_counts_fma[C=63]"] = dict(
        shape=f"N={n} D={d} C=63", **counts_agree("seed_counts_fma", few),
        ms=cuda_ms(torch, lambda: km.seed_counts(x, mask, few)),
        plain_ms=cuda_ms(torch, lambda: km.seed_counts_plain(x, mask, few)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n * d * 4 + n + 63 * 8, 2.0 * 63 * n * d))))


def pruned_phase(torch, native, card: str, perf: dict, results: dict,
                 launch_of: dict, ctx: dict, trace=False, out_dir="smoke_out"):
    """The 1M index served in the pruned regime, and its kernels against
    their plain versions on the index's own device state."""
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.index import ivf as iv
    from fabstir_vectordb_tpu_torch.index.hybrid import SearchConfig
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import limits

    h, x, centers, cfg = ctx["h"], ctx["x"], ctx["centers"], ctx["cfg"]
    n, d, n_recent = ctx["n"], ctx["d"], ctx["n_recent"]
    old_thr = limits.FLAT_THRESHOLD

    def regime(pruned: bool) -> None:
        if pruned:  # as bench.py's bench_pruned forces it
            os.environ["FVDB_PCA_SERVE"] = "0"
            os.environ["FVDB_FLAT_THRESHOLD"] = "0"
            limits.FLAT_THRESHOLD = 0
        else:
            os.environ.pop("FVDB_PCA_SERVE", None)
            os.environ.pop("FVDB_FLAT_THRESHOLD", None)
            limits.FLAT_THRESHOLD = old_thr
        want = "pruned" if pruned else "flat-exact"
        if h.fused.serving_info()["regime"] != want:
            fail(f"serving_info: {h.fused.serving_info()}, expected {want}")

    rng = ctx["rng"]

    def noisy(rows):
        return (x[rows] + 0.3 * rng.standard_normal((len(rows), d))) \
            .astype(np.float32)

    def from_both(m):  # half from the HNSW rows, half from the IVF rows
        return np.concatenate([rng.integers(0, n_recent, m // 2),
                               rng.integers(n_recent, n, m - m // 2)])

    qs, qb = noisy(from_both(256)), noisy(from_both(1024))
    regime(True)
    t = time.perf_counter()
    h.search_rows(qs[:1], 10, cfg, now=NOW)
    state_s = time.perf_counter() - t
    lat, single = [], []
    for q in qs:
        t = time.perf_counter()
        single.append(h.search_rows(q[None], 10, cfg, now=NOW)[1][0])
        lat.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    batched = [h.search_rows(qb[i * 128:(i + 1) * 128], 10, cfg,
                             now=NOW)[1] for i in range(8)]
    batch_s = time.perf_counter() - t
    single, batched = np.stack(single), np.concatenate(batched)

    # per-engine k: at most 5 HNSW rows among the 10
    _, pe = h.search_rows(qs[:16], 10, SearchConfig(
        recent_k=5, historical_k=10, auto_migrate=False), now=NOW)
    if (pe < 0).any() or ((pe < n_recent).sum(1) > 5).any():
        fail(f"per-engine search: {pe}")
    fmask = np.arange(h.store.capacity) % 10 == 3
    filtered = {}
    for k in (10, 100):
        res = h.search_with_filter(qs[0], k, {"cat": 3}, row_mask=fmask,
                                   now=NOW)
        rows = [int(v[1:]) for v, _ in res]
        if len(rows) != k or not fmask[rows].all():
            fail(f"pruned filtered k={k}: {len(rows)} rows, a row outside "
                 f"the mask: {not fmask[rows].all()}")
        filtered[k] = rows
    _, r300 = h.search_rows(qs[:4], 300, cfg, now=NOW)
    if (r300 < 0).any() or any(len(set(r)) != 300 for r in r300):
        fail("pruned k=300 search")

    # exact answers from the flat regime (K1 over every member)
    regime(False)
    ex_single = np.concatenate([h.search_rows(qs[i:i + 128], 10, cfg,
                                              now=NOW)[1]
                                for i in range(0, 256, 128)])
    ex_batched = np.concatenate([h.search_rows(qb[i:i + 128], 10, cfg,
                                               now=NOW)[1]
                                 for i in range(0, 1024, 128)])
    _, e300 = h.search_rows(qs[:4], 300, cfg, now=NOW)
    if (e300 < 0).any():
        fail("flat k=300 search")
    for k in (10, 100):
        res = h.search_with_filter(qs[0], k, {"cat": 3}, row_mask=fmask,
                                   now=NOW)
        rows = [int(v[1:]) for v, _ in res]
        if len(rows) != k or not fmask[rows].all():
            fail(f"flat filtered k={k}")
        filtered[f"recall{k}"] = len(set(rows) & set(filtered[k])) / k
    rec_single = recall(single, ex_single)
    rec_batched = recall(batched, ex_batched)
    rec300 = recall(r300, e300, 300)
    if min(rec_single, rec_batched) < 0.95:
        fail(f"pruned recall@10 {rec_single} / {rec_batched} < 0.95")

    # deletes, the entry point and earlier top hits among them
    regime(True)
    ep = h.hnsw.entry_point
    top = [int(r) for row in single[:50] for r in row[:5] if r >= 0]
    dead = list(dict.fromkeys([ep] + top + rng.choice(n, 1000).tolist()))
    dead = np.array(dead[:1000])
    if h.batch_delete([f"v{r}" for r in dead]) != 1000:
        fail("batch_delete")
    _, after = h.search_rows(qs[:128], 10, cfg, now=NOW)
    _, after_b = h.search_rows(qb[:128], 10, cfg, now=NOW)
    if np.isin(after, dead).any() or np.isin(after_b, dead).any():
        fail("pruned: a deleted row was returned")
    if h.hnsw.entry_point == ep:
        fail("pruned: the deleted entry point was not replaced")

    # 2,048 new recent rows, linked through the beam plan (threshold 0)
    before = {k: native.launches[k] for k in ("greedy_descent",
                                              "beam_search", "l2_topk")}
    new = (centers[rng.integers(0, 1024, 2048)] + 0.35 * rng.standard_normal(
        (2048, d))).astype(np.float32)
    t = time.perf_counter()
    new_rows = h.insert_batch([f"n{i}" for i in range(2048)], new,
                              np.full(2048, NOW - DAY), now=NOW)
    torch.cuda.synchronize()
    link_s = time.perf_counter() - t
    if native.launches["greedy_descent"] == before["greedy_descent"] \
            or native.launches["beam_search"] == before["beam_search"] \
            or native.launches["l2_topk"] != before["l2_topk"]:
        fail("the 2,048 inserts did not link through the beam plan")
    _, me = h.search_rows(new, 1, cfg, now=NOW)
    self_rate = float((me[:, 0] == new_rows).mean())
    if self_rate < 0.99:
        fail(f"beam-linked inserts found at rank 1: {self_rate} < 0.99")
    torch.cuda.synchronize()
    counts = dict(native.launches)
    note_shapes("pruned-1M (with the 1M build)", native)
    # K6 on the tensor cores: the 1M build's IVF training (256 lists)
    launch_of["lloyd_block[65536x256]"] = counts["lloyd_block"]
    for name in ("l2_topk", "l2_topk_large", "heuristic_kept", "pair_sq_l2",
                 "lloyd_block", "greedy_descent", "beam_search", "ivf_scan"):
        if counts[name] <= 0:
            fail(f"pruned path: {name} was launched no time")
    p50 = float(np.percentile(lat, 50))
    qps = 1024 / batch_s
    perf.update(pruned_state_build_s=state_s, pruned_search_p50_ms=p50,
                pruned_batched_qps=qps, pruned_recall_at_10_single=rec_single,
                pruned_recall_at_10_batched=rec_batched,
                pruned_recall_at_300=rec300,
                pruned_filtered_k10_agreement=filtered["recall10"],
                pruned_filtered_k100_agreement=filtered["recall100"],
                beam_link_s=link_s, beam_link_self_rank1=self_rate)
    print(f"pruned: search p50 {p50:.3f} ms over 256 single k=10 searches, "
          f"batched {qps:.1f} QPS over 8 x 128; recall@10 {rec_single:.4f} "
          f"(single) {rec_batched:.4f} (batched), @300 {rec300:.4f}; "
          f"filtered k=10/100 agree with exact {filtered['recall10']:.2f}/"
          f"{filtered['recall100']:.2f}; 2,048 beam-linked inserts in "
          f"{link_s:.3f} s, {self_rate:.4f} at rank 1 ({card})", flush=True)
    print(f"pruned: launches {counts}", flush=True)
    if trace:  # device busy share of the two pruned search shapes
        for name, fn in (
                ("pruned_single", lambda: [h.search_rows(q[None], 10, cfg,
                                                         now=NOW)
                                           for q in qs[:64]]),
                ("pruned_batched", lambda: [h.search_rows(
                    qb[i * 128:(i + 1) * 128], 10, cfg, now=NOW)
                    for i in range(4)])):
            wall, dev_ms = device_trace(torch, name, fn, out_dir)
            print(f"trace {name}: wall {wall:.3f} ms, device {dev_ms:.3f} "
                  f"ms, busy share {dev_ms / wall:.3f} ({card})", flush=True)

    # ---- kernels against their plain versions, on this index's state
    st = h.fused._device_state(pruned=True)
    work = {}  # (bytes, flops) of each kernel's call, for its bound
    dev = st["x"].device
    x_d, xsq_d = st["x"], st["x_sq"]
    qd = torch.from_numpy(qb[:128]).to(dev)
    m_up = int(st["nbrs_up"].shape[1])
    hm = st["hnsw_mask"]
    fm = torch.from_numpy(fmask[:x_d.shape[0]]).to(dev)

    # K10, at B = 128 and one query
    gargs = (x_d, xsq_d, hm, st["nbrs_up"], st["up_offset"], qd, st["entry"],
             st["entry_level"])
    shape = f"M={m_up} D={d} levels={st['entry_level']}"
    work["greedy_descent"] = k10_entry(torch, hn, results, "greedy_descent",
                                       gargs, f"B=128 {shape}")
    k10_entry(torch, hn, results, "greedy_descent[B=1]",
              gargs[:5] + (qd[:1],) + gargs[6:], f"B=1 {shape}")
    ck = hn.greedy_descent(*gargs)[0]
    launch_of["greedy_descent"] = counts["greedy_descent"]
    launch_of["greedy_descent[B=1]"] = counts["greedy_descent"]

    # K11: serve (ef 64, W 4, +- the filter; B = 128 and one query) and
    # link (ef 200, W 1)
    ex_h = tp.l2_topk(x_d, xsq_d, hm, qd, 10)[1].cpu().numpy()
    ex_hf = tp.l2_topk(x_d, xsq_d, hm & fm, qd, 10)[1].cpu().numpy()
    ql = torch.from_numpy(new[:1024]).to(dev)
    cl, _ = hn.greedy_descent(x_d, xsq_d, hm, st["nbrs_up"], st["up_offset"],
                              ql, st["entry"], st["entry_level"])
    for tag, qq, start, ef, w, rm, exact in (
            ("serve", qd, ck, 64, limits.beam_expand(), None, ex_h),
            ("serve B=1", qd[:1], ck[:1], 64, limits.beam_expand(), None,
             ex_h[:1]),
            ("serve-filtered", qd, ck, 64, limits.beam_expand(), fm, ex_hf),
            ("link", ql, cl, 200, 1, None, None)):
        args = (x_d, xsq_d, hm, st["nbrs0"], st["nbrs_up"], st["up_offset"],
                qq, start[:, None].contiguous(), None, 0, ef, ef + 32, rm,
                True, w)
        bk, ik = hn.beam_search(*args)
        bst = {}
        bp, ip = hn.beam_search_plain(*args, stats=bst)
        ik_n, ip_n = ik.cpu().numpy(), ip.cpu().numpy()
        ov = overlap(ik_n, ip_n)
        if ov < 0.99:
            fail(f"beam_search[{tag}]: overlap {ov} with plain < 0.99")
        rk = rp = None
        if exact is not None:
            rk, rp = recall(ik_n, exact), recall(ip_n, exact)
            if abs(rk - rp) > 0.005:
                fail(f"beam_search[{tag}]: recall@10 {rk} vs plain {rp}")
        both = (ik == ip) & (ik >= 0)
        err = float((bk - bp)[both].abs().max()) if both.any() else 0.0
        b = qq.shape[0]
        seen = int(bst["seen"].sum())
        work[f"beam_search[{tag}]"] = (
            seen * (d * 4 + 4 + 1) + bst["parents"] * 32 * 4 + b * d * 4
            + b * ef * 8, bst["rows"] * 2.0 * d)
        bms, by = bound(*work[f"beam_search[{tag}]"])
        results[f"beam_search[{tag}]"] = dict(
            shape=f"B={b} ef={ef} W={w} M0=32 D={d}", max_abs_err=err,
            overlap=ov, recall_at_10=rk, plain_recall_at_10=rp,
            steps=bst["steps"], steps_max=bst["steps_max"], rows=bst["rows"],
            distinct_rows=seen, warps_a_query=hn.beam_plan(b, w, 32),
            ms=cuda_ms(torch, lambda: hn.beam_search(*args)),
            plain_ms=cuda_ms(torch, lambda: hn.beam_search_plain(*args),
                             iters=2, warmup=1),
            bound_ms=bms, bound_by=by)
        launch_of[f"beam_search[{tag}]"] = counts["beam_search"]

    # K12 (its centroid ranking is K1) and K13
    k_srv = 16  # bucket(10)
    lists = st["ivf"]
    ivf_args = (x_d, xsq_d, st["ivf_mask"], lists, qd, k_srv, 16)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    vk, rk_, pk = iv.ivf_search(*ivf_args)
    torch.cuda.synchronize()
    k12_mem = torch.cuda.max_memory_allocated() - base_mem
    vp, rp_, pp = iv.ivf_search_plain(*ivf_args)
    if not bool((pk == pp).all()):
        fail("ivf_search: the probed lists differ from the plain version's")
    tol = 2e-5 * float(xsq_d.max() + (qd * qd).sum(1).max())
    err, differ = topk_check("ivf_scan", vk, rk_, vp, rp_, tol)
    nbytes, flops, pairs, rows_once = ivf_work(
        lists, st["ivf_mask"], pk, 128, k_srv, d, 4)
    work["ivf_scan"] = (nbytes, flops)
    tl = lists.tiles
    n_c = int(lists.centroids.shape[0])
    bms, by = bound(*work["ivf_scan"])
    scan_args = (x_d, xsq_d, st["ivf_mask"], lists, pk, qd, k_srv)
    results["ivf_scan"] = dict(
        shape=f"B=128 C={n_c} n_probe=16 k={k_srv} L_pad={tl.shape[1]} "
              f"(query, row) pairs={pairs} distinct rows={rows_once}",
        max_abs_err=err, tol=tol, rows_differing_at_ties=differ,
        peak_bytes=k12_mem,
        ms=cuda_ms(torch, lambda: iv.ivf_search(*ivf_args)),
        plain_ms=cuda_ms(torch, lambda: iv.ivf_search_plain(*ivf_args),
                         iters=2, warmup=1),
        bound_ms=bms, bound_by=by,
        stage_us=k12_stage_us(torch, lambda: iv.ivf_scan(*scan_args)),
        modelled_reads=k12_reads(torch, lists, st["ivf_mask"], pk, d, 4))
    launch_of["ivf_scan"] = counts["ivf_scan"]
    # B = 1 (single searches: the per-query route) and every query probing
    # the longest list (one list's groups and chunks), against the plain
    # version on the same probes
    one = tuple(a[:1] if i in (4, 5) else a for i, a in enumerate(scan_args))
    vk, rk_ = iv.ivf_scan(*one)
    vp, rp_ = iv.ivf_scan_plain(*one)
    err1, differ1 = topk_check("ivf_scan[B=1]", vk, rk_, vp, rp_, tol)
    rd1 = k12_reads(torch, lists, st["ivf_mask"], pk[:1], d, 4,
                    grouped=False)
    bms1, by1 = bound(rd1["distinct_bytes"], 2.0 * d * rd1["rows_read"])
    results["ivf_scan[B=1]"] = dict(
        shape=f"B=1 C={n_c} n_probe=16 k={k_srv} (the per-query route)",
        max_abs_err=err1, tol=tol, rows_differing_at_ties=differ1,
        ms=cuda_ms(torch, lambda: iv.ivf_scan(*one)),
        device_us=float(np.median(device_us_each(
            torch, [lambda: iv.ivf_scan(*one)] * 20))),
        plain_ms=cuda_ms(torch, lambda: iv.ivf_scan_plain(*one), iters=2,
                         warmup=1),
        bound_ms=bms1, bound_by=by1,
        stage_us=k12_stage_us(torch, lambda: iv.ivf_scan(*one)),
        modelled_reads=rd1)
    launch_of["ivf_scan[B=1]"] = counts["ivf_scan"]
    longest = int(torch.argmax(lists.list_len))
    same = torch.full_like(pk[:, :1], longest)
    vk, rk_ = iv.ivf_scan(x_d, xsq_d, st["ivf_mask"], lists, same, qd, k_srv)
    vp, rp_ = iv.ivf_scan_plain(x_d, xsq_d, st["ivf_mask"], lists, same, qd,
                                k_srv)
    e_same, _ = topk_check("ivf_scan[one list]", vk, rk_, vp, rp_, tol)
    results["ivf_scan"]["one_list_check"] = (
        f"128 queries on list {longest} "
        f"({int(lists.list_len[longest])} entries), max_abs_err {e_same}")
    hy_args = (x_d, xsq_d, hm, st["ivf_mask"], st["ones"], st["nbrs0"],
               st["nbrs_up"], st["up_offset"], st["entry"],
               st["entry_level"], lists, qd, k_srv, 64, 16, st["has_hnsw"])
    hy_kw = dict(beam_expand=limits.beam_expand())
    _, hk = fu.hybrid_search(*hy_args, **hy_kw)
    _, hp = fu.hybrid_search_plain(*hy_args, **hy_kw)
    ex_all = tp.l2_topk(x_d, xsq_d, st["members"], qd, 10)[1].cpu().numpy()
    hk_n, hp_n = hk.cpu().numpy()[:, :10], hp.cpu().numpy()[:, :10]
    ov = overlap(hk_n, hp_n)
    rk, rp = recall(hk_n, ex_all), recall(hp_n, ex_all)
    if ov < 0.99 or abs(rk - rp) > 0.005:
        fail(f"hybrid_search: overlap {ov}, recall@10 {rk} vs plain {rp}")
    parts = ("greedy_descent", "beam_search[serve]", "ivf_scan")
    bms, by = bound(sum(work[p][0] for p in parts),
                    sum(work[p][1] for p in parts))
    perf["hybrid_search"] = dict(
        shape="B=128 k=16 ef=64 n_probe=16", overlap=ov, recall_at_10=rk,
        plain_recall_at_10=rp,
        ms=cuda_ms(torch, lambda: fu.hybrid_search(*hy_args, **hy_kw)),
        plain_ms=cuda_ms(torch, lambda: fu.hybrid_search_plain(
            *hy_args, **hy_kw), iters=2, warmup=1),
        bound_ms=bms, bound_by=f"{by}: K10 + K11[serve] + K12 work")
    print(f"composition hybrid_search (K13, no kernel of its own): "
          + " ".join(f"{k}={v}" for k, v in perf["hybrid_search"].items()),
          flush=True)

    # K1's k > 256 path at the filtered-search sizes, over the 1M mirror
    mem = st["members"]
    n_in = int(mem.sum())
    for k in (1024, 16_384):
        q4 = qd[:4].contiguous()
        vk, rk_ = tp.l2_topk(x_d, xsq_d, mem, q4, k)
        vp, rp_ = tp.l2_topk_plain(x_d, xsq_d, mem, q4, k)
        tol = 2e-5 * float(xsq_d.max() + (q4 * q4).sum(1).max())
        err, differ = topk_check(f"l2_topk[k={k}]", vk, rk_, vp, rp_, tol)
        nn = int(x_d.shape[0])
        bms, by = route_bound(nn * d * 4 + nn * 4 + nn + 4 * d * 4
                              + 4 * k * 8, 2.0 * 4 * n_in * d,
                              fu.tile_route(x_d.dtype, False, d))
        results[f"l2_topk[k={k}]"] = dict(
            shape=f"B=4 N={nn} D={d} k={k}", max_abs_err=err, tol=tol,
            rows_differing_at_ties=differ,
            ms=cuda_ms(torch, lambda: tp.l2_topk(x_d, xsq_d, mem, q4, k)),
            plain_ms=cuda_ms(torch, lambda: tp.l2_topk_plain(
                x_d, xsq_d, mem, q4, k), iters=2, warmup=1),
            bound_ms=bms, bound_by=by,
            tile_pass=fu.tile_route(x_d.dtype, False, d))
        launch_of[f"l2_topk[k={k}]"] = counts["l2_topk_large"]
    for name in ("greedy_descent", "greedy_descent[B=1]",
                 "beam_search[serve]",
                 "beam_search[serve-filtered]", "beam_search[link]",
                 "ivf_scan", "ivf_scan[B=1]", "l2_topk[k=1024]",
                 "l2_topk[k=16384]"):
        print_kernel(name, results[name], launch_of[name])
    regime(False)


# K14's stage 1 by route: the tensor cores, the FMA pass (a rank that is
# not a multiple of 8), and a launch whose survivors passed their buffer,
# run again on the FMA pass
S1_ROUTES = ("stage1_select", "stage1_select_fma", "stage1_select_overflow")


def print_kernel(name: str, r: dict, launches=None) -> None:
    print(f"kernel {name}: agree=True launches={launches} library_ms="
          f"{r.get('library_ms')} " + " ".join(
              f"{k}={v}" for k, v in r.items()
              if k not in ("library_ms", "modelled_reads")),
          flush=True)


def reduced_phase(torch, native, card: str, perf: dict, results: dict,
                  launch_of: dict, ctx: dict, trace=False,
                  out_dir="smoke_out"):
    """The 1M index served in the reduced-rank regime as bench.py's
    bench_pca runs it (flat threshold 0, FVDB_PCA_RERANK=device, rank and
    oversample auto): build, searches, recall@10 against the flat regime's
    exact answers, filters, deletes and a fresh insert, the memory premise,
    host mode, the pinned restart, the release on a regime switch; then
    K14, K2, K8 and K1 on bf16 rows against their plain versions on the
    regime's own state."""
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import limits
    from fabstir_vectordb_tpu_torch.utils.padding import bucket

    h, x, cfg = ctx["h"], ctx["x"], ctx["cfg"]
    n, d, n_recent = ctx["n"], ctx["d"], ctx["n_recent"]
    rng = np.random.default_rng(9)
    live = h.store.active_mask(h.store.capacity)

    def noisy(rows):
        return (x[rows] + 0.3 * rng.standard_normal((len(rows), d))) \
            .astype(np.float32)

    def from_both(m):  # half near HNSW rows, half near IVF rows
        return np.concatenate([rng.choice(np.nonzero(live[:n_recent])[0],
                                          m // 2),
                               rng.choice(np.nonzero(live[n_recent:n])[0]
                                          + n_recent, m - m // 2)])

    qs, qb = noisy(from_both(256)), noisy(from_both(1024))
    old_thr = limits.FLAT_THRESHOLD
    knobs = ("FVDB_PCA_SERVE", "FVDB_FLAT_THRESHOLD", "FVDB_PCA_RERANK",
             "FVDB_PCA_RANK", "FVDB_PCA_OVERSAMPLE")

    def regime(name: str, **env) -> None:
        for key in knobs:
            os.environ.pop(key, None)
        limits.FLAT_THRESHOLD = old_thr if name == "flat" else 0
        if name != "flat":
            os.environ["FVDB_FLAT_THRESHOLD"] = "0"
        if name == "pruned":
            os.environ["FVDB_PCA_SERVE"] = "0"
        os.environ.update(env)
        want = {"flat": "flat-exact", "reduced": "reduced-rank",
                "pruned": "pruned"}[name]
        if h.fused.serving_info()["regime"] != want:
            fail(f"serving_info: {h.fused.serving_info()}, expected {want}")

    def search(qq, k=10, **kw):
        return h.search_rows(qq, k, cfg, now=NOW, **kw)[1]

    def batched():
        return np.concatenate([search(qb[i * 128:(i + 1) * 128])
                               for i in range(8)])

    def build() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        search(qs[:1])
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # exact answers: the flat regime (K1 over every member)
    regime("flat")
    ex_single = np.concatenate([search(qs[i:i + 128]) for i in (0, 128)])
    ex_batched = batched()

    # ---- device stage 2, rank and oversample auto: the main path
    regime("reduced", FVDB_PCA_RERANK="device")
    native.reset_launches()
    build_s = build()
    info = h.fused.serving_info()
    proj = h.fused._proj
    print(f"reduced: state built in {build_s:.3f} s: rank {info['pca_rank']}"
          f" (doubled: {info['pca_rank_doubled']}), oversample "
          f"{info['pca_oversample']}, calibrated recall "
          f"{info['pca_calibrated_recall']}, stage 2 {info['pca_rerank']}, "
          f"{proj['n_rows']} mirror rows ({card})", flush=True)
    if info["pca_rerank"] != "device" or proj["rerank_x"] is None:
        fail(f"reduced: stage 2 is not on the device: {info}")
    # the memory premise: no full-dim f32 mirror while reduced-rank serves
    if h.fused._dev is not None or h.store._mirror is not None:
        fail("reduced: the full-dim f32 mirror is still held")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    own = sum(t.numel() * t.element_size() for t in (
        proj["xp"], proj["xp_sq"], proj["rerank_x"], h.fused._members_dev))
    f32_mirror = h.store.count * d * 4
    if held - own >= f32_mirror:
        fail(f"reduced: {held - own} bytes held beside the regime's own "
             f"{own}: as much as a full-dim f32 mirror ({f32_mirror})")
    lat, single = [], []
    for q in qs:
        t = time.perf_counter()
        single.append(search(q[None])[0])
        lat.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    bat = batched()
    batch_s = time.perf_counter() - t
    single = np.stack(single)
    rec_s, rec_b = recall(single, ex_single), recall(bat, ex_batched)
    if min(rec_s, rec_b) < 0.95:
        fail(f"reduced recall@10 {rec_s} / {rec_b} < 0.95")
    fmask = np.arange(h.store.capacity) % 10 == 3
    for k in (10, 100):
        res = h.search_with_filter(qs[0], k, {"cat": 3}, row_mask=fmask,
                                   now=NOW)
        rows = [h.store.row_of(v) for v, _ in res]
        if len(rows) != k or not fmask[rows].all() or not live[rows].all():
            fail(f"reduced filtered k={k}: {len(rows)} rows, one outside "
                 f"the mask or deleted")
    torch.cuda.synchronize()
    counts = dict(native.launches)
    note_shapes("reduced-1M", native)
    path = ("project_rows", "project_queries", "stage1_select", "rerank_f32",
            "l2_topk_bf16", "merge_topk")
    for name in path:
        if counts[name] <= 0:
            fail(f"reduced path: {name} was launched no time")
    p50 = float(np.percentile(lat[:100], 50))
    qps = 1024 / batch_s
    print(f"reduced: search p50 {p50:.3f} ms over 100 single k=10 searches,"
          f" batched {qps:.1f} QPS over 8 x 128; recall@10 {rec_s:.4f} "
          f"(256 single) {rec_b:.4f} (1,024 batched); filtered k=10/100 "
          f"exact to the filter; held beside the regime's state "
          f"{(held - own) / 1e6:.1f} MB of {held / 1e6:.1f} MB, a full-dim "
          f"f32 mirror would be {f32_mirror / 1e6:.1f} MB ({card})",
          flush=True)
    print(f"reduced: launches { {k: counts[k] for k in path + S1_ROUTES} }",
          flush=True)
    if trace:
        for name, fn in (
                ("reduced_single", lambda: [search(q[None]) for q in qs[:64]]),
                ("reduced_batched", lambda: [search(qb[i * 128:(i + 1) * 128])
                                             for i in range(4)])):
            wall, dev_ms = device_trace(torch, name, fn, out_dir)
            print(f"trace {name}: wall {wall:.3f} ms, device {dev_ms:.3f} "
                  f"ms, busy share {dev_ms / wall:.3f} ({card})", flush=True)

    # ---- kernels against their plain versions, on this state
    xp, xp_sq, rx = proj["xp"], proj["xp_sq"], proj["rerank_x"]
    mu, pm = proj["mu"], proj["p"]
    n_rows, r = xp.shape
    mem = h.fused._members_state(n_rows)
    n_in = int(mem.sum())
    dev = xp.device
    ov_serve = min(bucket(16 * info["pca_oversample"]), n_rows)  # k 10 -> 16
    m_serve = min(64, ov_serve)
    q128 = torch.from_numpy(qb[:128]).to(dev)
    qp128 = fu.project_queries(q128, mu, pm)
    # the serving pool at B = 1 and 128, and a pool of 1,024 if it is not
    cases = [("B=1", 1, ov_serve), ("B=128", 128, ov_serve)]
    if ov_serve != 1024:
        cases.append(("B=128 ov=1024", 128, min(1024, n_rows)))
    stage1_keys = [f"stage1_select[{tag}]" for tag, _, _ in cases]
    for tag, b, ov in cases:
        qp = qp128[:b].contiguous()
        vk, rk = fu.stage1_select(xp, xp_sq, mem, qp, ov)
        vp, rp = fu.stage1_select_plain(xp, xp_sq, mem, qp, ov)
        tol = 2e-5 * float(xp_sq.max() + (qp * qp).sum(1).max())
        err, differ = topk_check(f"stage1_select[{tag}]", vk, rk, vp, rp, tol)
        bms, by = bound(n_rows * (r * 2 + 4 + 1) + b * r * 4 + b * ov * 8,
                        2.0 * b * n_in * r, BF16_FLOPS)
        key = f"stage1_select[{tag}]"
        results[key] = dict(
            shape=f"B={b} N={n_rows} r={r} ov_k={ov} members={n_in}",
            max_abs_err=err, tol=tol, rows_differing_at_ties=differ,
            ms=cuda_ms(torch, lambda: fu.stage1_select(xp, xp_sq, mem, qp,
                                                       ov)),
            plain_ms=cuda_ms(torch, lambda: fu.stage1_select_plain(
                xp, xp_sq, mem, qp, ov), iters=2, warmup=1),
            library_ms=None, bound_ms=bms,
            bound_by=f"{by} (bf16 tensor-core rate)",
            tile_pass=fu.tile_route(torch.bfloat16, True, r),
            **{f"{c}_launches": counts[c] for c in S1_ROUTES[1:]})
        launch_of[key] = counts["stage1_select"]
    # the dump route (csrc/stage1_select.cu: the FMA pass into a [B, N]
    # buffer, the radix select), which stage 1 takes at a rank off the
    # tensor cores and where a launch's survivors pass their buffer: forced
    # here by a buffer of half the pool a query
    route = "stage1_select_overflow" if fu.tile_route(
        torch.bfloat16, True, r) == "wgmma" else "stage1_select_fma"
    before = native.launches[route]
    vk, rk = fu.stage1_select(xp, xp_sq, mem, qp128, ov_serve,
                              capacity=ov_serve // 2)
    launched = native.launches[route] - before
    if launched < 1:
        fail(f"stage1_select: {route} was launched no time")
    vp, rp = fu.stage1_select_plain(xp, xp_sq, mem, qp128, ov_serve)
    tol = 2e-5 * float(xp_sq.max() + (qp128 * qp128).sum(1).max())
    err, differ = topk_check("stage1_select[dump route]", vk, rk, vp, rp, tol)
    bms, by = bound(n_rows * (r * 2 + 4 + 1) + 128 * r * 4 + 128 * n_rows * 4
                    + 128 * ov_serve * 8, 2.0 * 128 * n_in * r)
    ROUTE_CHECKS["stage1_select[dump route]"] = dict(
        shape=f"B=128 N={n_rows} r={r} ov_k={ov_serve} capacity "
              f"{ov_serve // 2}", route=route, launches_in_check=launched,
        max_abs_err=err, tol=tol, rows_differing_at_ties=differ,
        # the whole call: the launch that overflows, then the dump route
        ms=cuda_ms(torch, lambda: fu.stage1_select(
            xp, xp_sq, mem, qp128, ov_serve, capacity=ov_serve // 2)),
        bound_ms=bms, bound_by=f"{by} (f32 FMA rate, the buffer)")
    # K14 projection: one block of the device-mode build
    blk_n = min(524_288, n_rows)
    blk = rx[:blk_n]
    out_k = torch.empty((blk_n, r), dtype=torch.bfloat16, device=dev)
    sq_k = torch.empty(blk_n, device=dev)
    out_p, sq_p = torch.empty_like(out_k), torch.empty_like(sq_k)
    fu.project_rows(blk, mu, pm, out_k, sq_k, 0)
    fu.project_rows_plain(blk, mu, pm, out_p, sq_p, 0)
    yk, yp = out_k.float(), out_p.float()
    same = yk == yp
    share = float(same.float().mean())
    # one bf16 ulp of the larger of the two, or (where the product cancels
    # to near 0) the f32 sums' own spread, 1e-6 of the block's scale
    big = torch.maximum(yk.abs(), yp.abs()).clamp_min(1e-30)
    slack = torch.maximum(torch.exp2(torch.floor(torch.log2(big)) - 7)
                          * 1.0001, 1e-6 * yp.abs().max())
    if share < 0.999 or bool(((yk - yp).abs()[~same] > slack[~same]).any()):
        fail(f"project_rows: {share} of elements equal, or one off by more "
             f"than a bf16 ulp")
    rows_eq = same.all(1)
    sq_err = float(((sq_k - sq_p).abs() / sq_p.clamp_min(1e-30))[rows_eq]
                   .max())
    if sq_err > 1e-6:
        fail(f"project_rows: norms off by {sq_err} relative")
    if not torch.equal(out_k, xp[:blk_n]):
        fail("project_rows: the served mirror's first block differs")
    centered = blk.float() - mu
    bms, by = project_bound(blk_n, d, r)
    results["project_rows"] = dict(
        shape=f"n={blk_n} D={d} r={r}", max_abs_err=float(
            (yk - yp).abs().max()), equal_share=share,
        equal_share_off_center=off_center_share(torch, fu, blk[:131_072], pm),
        norm_rel_err=sq_err,
        ms=cuda_ms(torch, lambda: fu.project_rows(blk, mu, pm, out_k, sq_k,
                                                  0)),
        plain_ms=cuda_ms(torch, lambda: fu.project_rows_plain(
            blk, mu, pm, out_p, sq_p, 0), iters=2, warmup=1),
        library_ms=cuda_ms(torch, lambda: torch.matmul(centered, pm)),
        bound_ms=bms, bound_by=f"{by} (3 bf16 products, tensor-core rate)")
    launch_of["project_rows"] = counts["project_rows"]
    del centered
    pk, pp = fu.project_queries(q128, mu, pm), \
        fu.project_queries_plain(q128, mu, pm)
    err = float((pk - pp).abs().max())
    tol = 1e-5 * float(pp.abs().max()) * 10
    if err > tol:
        fail(f"project_queries: max_abs_err {err} > {tol}")
    qc = q128 - mu
    bms, by = bound(128 * d * 4 + d * r * 4 + d * 4 + 128 * r * 4,
                    2.0 * 128 * d * r)
    results["project_queries"] = dict(
        shape=f"B=128 D={d} r={r}", max_abs_err=err, tol=tol,
        ms=cuda_ms(torch, lambda: fu.project_queries(q128, mu, pm),
                   iters=200),
        plain_ms=cuda_ms(torch, lambda: fu.project_queries_plain(
            q128, mu, pm), iters=200),
        library_ms=cuda_ms(torch, lambda: torch.matmul(qc, pm), iters=200),
        host_us=host_us(torch, lambda: fu.project_queries(q128, mu, pm)),
        library_host_us=host_us(torch, lambda: torch.matmul(qc, pm)),
        bound_ms=bms, bound_by=by)
    launch_of["project_queries"] = counts["project_queries"]
    # K2 on the serving pool of 128 queries and of one; past the fused
    # select, a filtered search's wide pool (stage 1 to 16,384, k = 100:
    # m 512) on the radix route
    _, pool = fu.stage1_select(xp, xp_sq, mem, qp128, ov_serve)
    k2_entry(torch, fu, results, "rerank_f32", rx, q128, pool, m_serve)
    k2_entry(torch, fu, results, "rerank_f32[B=1]", rx, q128[:1].contiguous(),
             pool[:1].contiguous(), m_serve)
    _, wide = fu.stage1_select(xp, xp_sq, mem, qp128[:4].contiguous(),
                               16_384)
    k2_entry(torch, fu, results, "rerank_f32[radix]", rx,
             q128[:4].contiguous(), wide, 512)
    launch_of["rerank_f32"] = counts["rerank_f32"]
    launch_of["rerank_f32[B=1]"] = counts["rerank_f32"]
    launch_of["rerank_f32[radix]"] = counts["rerank_f32_radix"]
    # K8: the oracle step at 128 probes over the build's first two blocks
    # (K1 on bf16 rows, then the merge), and each kernel alone
    width = 11
    steps = {}
    for tag, step in (("kernel", fu.oracle_step),
                      ("plain", fu.oracle_step_plain)):
        vals = torch.full((128, width), float("inf"), device=dev)
        rows = torch.full((128, width), -1, dtype=torch.int32, device=dev)
        for lo in range(0, min(2 * blk_n, n_rows), blk_n):
            hi = min(lo + blk_n, n_rows)
            vals, rows = step(rx[lo:hi], mem[lo:hi], q128, lo, vals, rows,
                              width)
        steps[tag] = (vals, rows)
    tol = 2e-5 * float((blk.float() ** 2).sum(1).max()
                       + (q128 * q128).sum(1).max())
    err, differ = topk_check("oracle_step", *steps["kernel"],
                             *steps["plain"], tol)
    m0 = mem[:blk_n]
    b_in = int(m0.sum())
    vk, rk = tp.l2_topk(blk, None, m0, q128, width)
    vp, rp = tp.l2_topk_plain(blk, None, m0, q128, width)
    err1, differ1 = topk_check("l2_topk[bf16]", vk, rk, vp, rp, tol)
    # three bf16 products (the query's exact split) on the tensor cores;
    # the FMA pass's bound beside
    nbytes = blk_n * (d * 2 + 1) + 128 * d * 4 + 128 * width * 8
    route = tp.tile_route(blk.dtype, False, d)
    bms, by = route_bound(nbytes, 2.0 * 128 * b_in * d + 2.0 * blk_n * d,
                          route)
    results["l2_topk[bf16]"] = dict(
        shape=f"B=128 N={blk_n} D={d} k={width} (bf16 rows, norms in the "
              f"kernel)", max_abs_err=err1, tol=tol,
        rows_differing_at_ties=differ1, oracle_step_err=err,
        oracle_step_rows_differing_at_ties=differ,
        ms=cuda_ms(torch, lambda: tp.l2_topk(blk, None, m0, q128, width)),
        plain_ms=cuda_ms(torch, lambda: tp.l2_topk_plain(
            blk, None, m0, q128, width), iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by, tile_pass=route,
        bound_fma_ms=bound(nbytes, 2.0 * 128 * b_in * d + 2.0 * blk_n * d)[0])
    launch_of["l2_topk[bf16]"] = counts["l2_topk_bf16"]
    va, ra = steps["plain"]
    mk = tp.merge_topk(va, ra, vk, rk, width)
    mp = tp.merge_topk_plain(va, ra, vk, rk, width)
    if not (torch.equal(mk[0], mp[0]) and torch.equal(mk[1], mp[1])):
        fail("merge_topk: differs from the plain version")
    bms, by = bound(3 * 128 * width * 8, 0.0)
    results["merge_topk"] = dict(
        shape=f"B=128 k={width} + {width}", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: tp.merge_topk(va, ra, vk, rk, width)),
        plain_ms=cuda_ms(torch, lambda: tp.merge_topk_plain(
            va, ra, vk, rk, width)), library_ms=None, bound_ms=bms,
        bound_by=by)
    launch_of["merge_topk"] = counts["merge_topk"]
    for name in (*stage1_keys, "project_rows", "project_queries",
                 "rerank_f32", "rerank_f32[B=1]", "rerank_f32[radix]",
                 "l2_topk[bf16]", "merge_topk"):
        print_kernel(name, results[name], launch_of[name])
    del proj, xp, xp_sq, rx, blk, out_k, out_p, sq_k, sq_p, pool, wide

    # ---- host stage 2 on the same index
    h.fused._release_proj()
    regime("reduced", FVDB_PCA_RERANK="host")
    host_build_s = build()
    if h.fused.serving_info()["pca_rerank"] != "host":
        fail("reduced: host mode did not take stage 2 to the host")
    t = time.perf_counter()
    host_single = np.stack([search(q[None])[0] for q in qs])
    host_single_s = time.perf_counter() - t
    host_bat = batched()
    rec_hs, rec_hb = recall(host_single, ex_single), recall(host_bat,
                                                            ex_batched)
    if min(rec_hs, rec_hb) < 0.95:
        fail(f"reduced host-mode recall@10 {rec_hs} / {rec_hb} < 0.95")
    shared = overlap(np.concatenate([host_single, host_bat]),
                     np.concatenate([single, bat]))
    print(f"reduced host mode: state built in {host_build_s:.3f} s; "
          f"recall@10 {rec_hs:.4f} (single) {rec_hb:.4f} (batched); "
          f"{shared:.4f} of rows shared with device mode; 256 single "
          f"searches in {host_single_s:.3f} s ({card})", flush=True)

    # ---- pinned restart: rank and oversample from this calibration
    h.fused._release_proj()
    regime("reduced", FVDB_PCA_RERANK="device",
           FVDB_PCA_RANK=str(info["pca_rank"]),
           FVDB_PCA_OVERSAMPLE=str(info["pca_oversample"]))
    before = (native.launches["l2_topk_bf16"], native.launches["merge_topk"])
    pinned_build_s = build()
    pinfo = h.fused.serving_info()
    if (native.launches["l2_topk_bf16"], native.launches["merge_topk"]) \
            != before or pinfo["pca_calibrated_recall"] is not None:
        fail(f"pinned restart ran the probe pass: {pinfo}")
    pin_bat = batched()
    if not np.array_equal(pin_bat, bat):
        fail(f"pinned restart: {float((pin_bat != bat).any(1).mean())} of "
             f"queries answer otherwise")
    print(f"reduced pinned restart: state built in {pinned_build_s:.3f} s "
          f"(auto: {build_s:.3f} s), no oracle launch, the same answers "
          f"({card})", flush=True)

    # ---- guarantees after 1,000 deletes and an insert
    top = [int(v) for row in single[:50] for v in row[:5] if v >= 0]
    pool_rows = np.nonzero(h.store.active_mask(h.store.count))[0]
    dead = list(dict.fromkeys(top + rng.choice(pool_rows, 1000).tolist()))
    dead = np.array(dead[:1000])
    if h.batch_delete([h.store.id_of(int(v)) for v in dead]) != 1000:
        fail("reduced: batch_delete")
    fresh = (x[7] + 0.01 * rng.standard_normal(d)).astype(np.float32)
    fresh_row = h.insert_batch(["fresh-0"], fresh[None],
                               np.full(1, NOW - 30 * DAY), now=NOW)[0]
    mut_s = build()
    after = np.concatenate([search(qs[:128]), search(qb[:128])])
    if np.isin(after, dead).any():
        fail("reduced: a deleted row was returned")
    me = search(fresh[None], 1)
    if int(me[0, 0]) != int(fresh_row):
        fail(f"reduced: the fresh insert came back as {me[0, 0]}, not at "
             f"rank 1")

    # ---- a regime switch releases the projection state
    regime("pruned")
    search(qs[:1])
    if h.fused._proj is not None:
        fail("reduced: FVDB_PCA_SERVE=0 kept the projection state")
    regime("flat")
    print(f"reduced: 1,000 deletes + 1 insert rebuilt in {mut_s:.3f} s, no "
          f"deleted row returned, the insert found at rank 1; "
          f"FVDB_PCA_SERVE=0 released the projection state ({card})",
          flush=True)
    perf.update(
        reduced_state_build_s=build_s, reduced_search_p50_ms=p50,
        reduced_batched_qps=qps, reduced_recall_at_10_single=rec_s,
        reduced_recall_at_10_batched=rec_b, reduced_rank=info["pca_rank"],
        reduced_rank_doubled=info["pca_rank_doubled"],
        reduced_oversample=info["pca_oversample"],
        reduced_calibrated_recall=info["pca_calibrated_recall"],
        reduced_held_beside_state_bytes=held - own,
        reduced_host_state_build_s=host_build_s,
        reduced_host_recall_at_10_single=rec_hs,
        reduced_host_recall_at_10_batched=rec_hb,
        reduced_host_shared_rows=shared,
        reduced_pinned_state_build_s=pinned_build_s)


FLAT1M_KNOBS = ("FVDB_SERVING_DTYPE", "FVDB_FLAT_SELECT", "FVDB_BF16_RERANK",
                "FVDB_BF16_REFINE", "FVDB_BF16_OVERSAMPLE",
                "FVDB_FLAT_OVERSAMPLE", "FVDB_FLAT_THRESHOLD",
                "FVDB_PCA_SERVE", "FVDB_PCA_RERANK", "FVDB_PCA_RANK",
                "FVDB_PCA_OVERSAMPLE")


def pool_check(tag, vk, rk, vp, rp, tol):
    """K9's pool (vk, rk) against its plain version's: the same padding,
    ascending distances, a mean overlap >= 0.99 (a near-tied bin minimum
    may go either way under another summation order), and the shared rows'
    distances within tol (1e-5 of the norms that the distance's expansion
    sums: a query near a stored row cancels them to a small distance).
    Returns (max_abs_err over the shared rows, overlap)."""
    vk, rk, vp, rp = (t.cpu().numpy() for t in (vk, rk, vp, rp))
    if not (np.isfinite(vk) == np.isfinite(vp)).all():
        fail(f"{tag}: padding differs from the plain version")
    if (np.diff(np.where(np.isfinite(vk), vk, np.inf), axis=1) < 0).any():
        fail(f"{tag}: the pool is not ascending")
    share = overlap(rk, rp)
    if share < 0.99:
        fail(f"{tag}: pools share {share} of rows < 0.99")
    return shared_err(tag, vk, rk, vp, rp, tol), share


def shared_err(tag, vk, rk, vp, rp, tol) -> float:
    """The largest distance difference over the rows that a query's two
    answers share (numpy arrays); fails past tol."""
    err = 0.0
    for i in range(rk.shape[0]):
        dk = dict(zip(rk[i].tolist(), vk[i].tolist()))
        for r, v in zip(rp[i].tolist(), vp[i].tolist()):
            if r >= 0 and r in dk:
                e = abs(dk[r] - v)
                if e > tol:
                    fail(f"{tag}: query {i} row {r} off by {e} > {tol}")
                err = max(err, e)
    return err


def flat1m_phase(torch, native, card: str, perf: dict, results: dict,
                 launch_of: dict, ctx: dict, trace=False,
                 out_dir="smoke_out"):
    """The 1M index in the flat regime at the default threshold, as
    bench.py's turbo phase (FVDB_FLAT_SELECT=approx) and the eager half of
    its cold-start phase (FVDB_SERVING_DTYPE=bfloat16) serve it: turbo
    single, batched and pipelined searches, recall@10 against the streamed
    exact oracle, a filtered batch and 1,000 deletes; bf16 serving in four
    modes (host refine, device re-score, raw, approx) with the mirror's
    bytes and the prewarm + first search; 2,048 inserts linked on the bf16
    mirror. The counters must show K9 on f32 and (tensor cores) bf16 rows,
    K2 on f32 and bf16 rows, K1 on bf16 rows with (tensor cores) and
    without the rounded query, K4 and K5 on bf16 rows; then each against
    its plain version at these shapes."""
    import gc

    from fabstir_vectordb_tpu_torch.index import tiered as ti
    from fabstir_vectordb_tpu_torch.utils import limits
    from fabstir_vectordb_tpu_torch.utils.transfer import to_device

    h, cfg, d = ctx["h"], ctx["cfg"], ctx["d"]
    store = h.store
    cap, count = store.capacity, store.count
    saved = {key: os.environ.get(key) for key in FLAT1M_KNOBS}
    old_thr = limits.FLAT_THRESHOLD

    def mode(**env) -> None:
        for key in FLAT1M_KNOBS:
            os.environ.pop(key, None)
        os.environ.update(env)
        info = h.fused.serving_info()
        if info["regime"] != "flat-exact" or info["serving_dtype"] != \
                env.get("FVDB_SERVING_DTYPE", "float32"):
            fail(f"flat1m: serving_info {info} for {env}")

    # bench.py's 1M query stream: stored rows + 0.1 noise; its QPS batches
    # are standard normal
    rng = np.random.default_rng(1018)
    live = store.active_mask(count)
    members = live & (h.hnsw.member_mask(count) | h.ivf.member_mask(count))
    seeds = rng.choice(np.nonzero(members)[0], 100)
    queries = (store.data[seeds] + 0.1 * rng.standard_normal((100, d))) \
        .astype(np.float32)
    sample = queries[:32]
    bq = [rng.standard_normal((128, d)).astype(np.float32) for _ in range(8)]
    pipe = [rng.standard_normal((128, d)).astype(np.float32)
            for _ in range(20)]
    fmask = np.arange(cap) % 10 == 3
    oracle = ti.TieredFlatSearcher(store.data[:count], members,
                                   device=store.torch_device)
    t = time.perf_counter()
    _, exact = oracle.search(sample, 10)
    _, exact_f = oracle.search(sample, 10, extra_mask=fmask[:count])
    oracle_s = time.perf_counter() - t

    def search(qq, k=10, **kw):
        return h.search_rows(qq, k, cfg, now=NOW, **kw)

    def serve(tag: str, pipelined: bool = False) -> dict:
        """p50 of 100 single searches, QPS of 8 x 128 (and of 20 x 128
        pipelined at depth 4), and the sample's answers."""
        search(queries[0])  # builds the state
        lat = []
        for q in queries:
            t = time.perf_counter()
            search(q)
            lat.append((time.perf_counter() - t) * 1e3)
        search(bq[0])
        t = time.perf_counter()
        for b in bq:
            search(b)
        out = {"p50_ms": float(np.percentile(lat, 50)),
               "qps": 1024 / (time.perf_counter() - t)}
        if pipelined:
            t = time.perf_counter()
            h.search_rows_pipelined(pipe, 10, cfg, now=NOW, depth=4)
            out["pipelined_qps"] = 2560 / (time.perf_counter() - t)
        out["dists"], out["rows"] = search(sample)
        out["recall"] = recall(out["rows"], exact)
        print(f"flat1m {tag}: p50 {out['p50_ms']:.3f} ms over 100 single "
              f"k=10 searches, {out['qps']:.1f} QPS over 8 x 128" + (
                  f", {out['pipelined_qps']:.1f} QPS over 20 x 128 "
                  f"pipelined at depth 4" if pipelined else "")
              + f"; recall@10 {out['recall']:.4f} over bench.py's 32-query "
              f"sample ({card})", flush=True)
        return out

    native.reset_launches()
    try:
        # ---- turbo on the f32 mirror
        mode(FVDB_FLAT_SELECT="approx")
        turbo = serve("turbo", pipelined=True)
        if turbo["recall"] < 0.95:
            fail(f"flat1m turbo recall@10 {turbo['recall']} < 0.95")
        _, rows_f = search(sample, extra_mask=fmask)
        ok = rows_f >= 0
        if not (fmask[rows_f[ok]].all() and live[rows_f[ok]].all()):
            fail("flat1m turbo: a filtered-out or deleted row was returned")
        rec_f = recall(rows_f, exact_f)
        top = [int(v) for row in turbo["rows"] for v in row[:3] if v >= 0]
        pool_rows = np.nonzero(members)[0]
        dead = list(dict.fromkeys(top + rng.choice(pool_rows, 1200)
                                  .tolist()))[:1000]
        if h.batch_delete([store.id_of(r) for r in dead]) != 1000:
            fail("flat1m: batch_delete")
        after = np.concatenate([search(sample)[1], search(bq[0])[1],
                                search(sample, extra_mask=fmask)[1]])
        if np.isin(after, dead).any():
            fail("flat1m turbo: a deleted row was returned")
        live = store.active_mask(count)
        _, exact = oracle.search(sample, 10, extra_mask=live)
        turbo_rec2 = recall(search(sample)[1], exact)
        if turbo_rec2 < 0.95:
            fail(f"flat1m turbo recall@10 after deletes {turbo_rec2} < 0.95")
        print(f"flat1m turbo: filtered recall@10 {rec_f:.4f} (every row in "
              f"the filter); 1,000 deletes, none returned, recall@10 "
              f"{turbo_rec2:.4f} after them; the exact oracle streamed in "
              f"{oracle_s:.3f} s ({card})", flush=True)
        if trace:
            for name, fn in (
                    ("turbo_single", lambda: [search(q) for q in queries[:64]]),
                    ("turbo_batched", lambda: [search(b) for b in bq[:4]])):
                wall, dev_ms = device_trace(torch, name, fn, out_dir)
                print(f"trace {name}: wall {wall:.3f} ms, device "
                      f"{dev_ms:.3f} ms, busy share {dev_ms / wall:.3f} "
                      f"({card})", flush=True)

        # ---- bf16 serving: the eager cold start, then four modes
        mode(FVDB_SERVING_DTYPE="bfloat16")
        store.release_mirror()
        h.fused._dev = h.fused._key = None
        store._host_sq = None  # a fresh process has no norms yet
        gc.collect()
        torch.cuda.synchronize()
        t = time.perf_counter()
        h.fused.prewarm()
        search(np.zeros((1, d), np.float32))
        cold_s = time.perf_counter() - t
        m = store._mirror
        mirror_bytes = m.x.numel() * m.x.element_size()
        if m.x.dtype != torch.bfloat16 or mirror_bytes * 2 != cap * d * 4:
            fail(f"flat1m: the bf16 mirror holds {mirror_bytes} bytes")
        bf16 = {}
        stored_exact = None
        for tag, env in (("refine", {}), ("rerank", {"FVDB_BF16_REFINE": "0"}),
                         ("raw", {"FVDB_BF16_RERANK": "0"}),
                         ("approx", {"FVDB_FLAT_SELECT": "approx"})):
            mode(FVDB_SERVING_DTYPE="bfloat16", **env)
            r = bf16[tag] = serve(f"bf16 {tag}", pipelined=tag == "refine")
            if tag == "refine":
                if r["recall"] < 0.95:
                    fail(f"flat1m bf16 refine recall@10 {r['recall']} < 0.95")
                rows = r["rows"]
                ref = np.sqrt(((store.data[rows].astype(np.float64)
                                - sample[:, None, :]) ** 2).sum(-1))
                err = float((np.abs(r["dists"] - ref) / ref).max())
                if err > 1e-4:
                    fail(f"flat1m bf16 refine: scores off the f64 distance "
                         f"of their rows by {err} relative")
                r["score_rel_err"] = err
            if tag == "rerank":
                # exact for the bf16-stored rows: a float64 brute force of
                # the sample over the mirror itself
                x64 = store._mirror.x.double()
                q64 = torch.from_numpy(sample).to(x64.device).double()
                d64 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ x64.T \
                    + (x64 * x64).sum(1)[None, :]
                keep = torch.zeros(cap, dtype=torch.bool, device=x64.device)
                keep[:count] = to_device(members & live, x64.device)
                d64[:, ~keep] = float("inf")
                stored_exact = torch.topk(d64, 10, largest=False).indices \
                    .cpu().numpy()
                del x64, d64
                r["recall_stored"] = recall(r["rows"], stored_exact)
                if r["recall_stored"] < 0.95:
                    fail(f"flat1m bf16 rerank: recall@10 against the stored "
                         f"rows {r['recall_stored']} < 0.95")
        print(f"flat1m bf16: mirror {mirror_bytes / 1e9:.3f} GB (f32 "
              f"{cap * d * 4 / 1e9:.3f} GB); prewarm + first search "
              f"{cold_s:.3f} s; refine scores within "
              f"{bf16['refine']['score_rel_err']:.2e} of the f64 distances; "
              f"rerank-only recall@10 against the bf16-stored rows "
              f"{bf16['rerank']['recall_stored']:.4f} ({card})", flush=True)

        # ---- 2,048 inserts linked on the bf16 mirror
        mode(FVDB_SERVING_DTYPE="bfloat16")
        base = rng.choice(np.nonzero(live)[0], 2048)
        fresh = (store.data[base] + 0.05 * rng.standard_normal((2048, d))) \
            .astype(np.float32)
        t = time.perf_counter()
        new_rows = h.insert_batch([f"bf16-{i}" for i in range(2048)], fresh,
                                  np.full(2048, NOW - DAY), now=NOW)
        torch.cuda.synchronize()
        ins_s = time.perf_counter() - t
        if store.capacity != cap:
            fail("flat1m: the inserts grew the store")
        found = np.concatenate([search(fresh[i:i + 512], 1)[1][:, 0]
                                for i in range(0, 2048, 512)])
        rank1 = float((found == new_rows).mean())
        if rank1 < 0.99:
            fail(f"flat1m bf16 inserts: {rank1} at rank 1 < 0.99")
        torch.cuda.synchronize()
        counts = dict(native.launches)
        note_shapes("flat1m", native)
        path = {"approx_topk_tf32": "K9 on f32 rows, three TF32 products "
                                    "(turbo)",
                "approx_topk": "K9 on bf16 rows, query rounded (tensor "
                               "cores)",
                "rerank_f32_rows": "K2 on f32 rows",
                "rerank_f32": "K2 on bf16 rows",
                "l2_topk_bf16_rq": "K1 on bf16 rows, query rounded (tensor "
                                   "cores)",
                "l2_topk_bf16": "K3 (K1 on bf16 rows, f32 query)",
                "heuristic_kept_bf16": "K4 on bf16 rows",
                "pair_sq_l2_bf16": "K5 on bf16 rows"}
        for name, what in path.items():
            if counts[name] <= 0:
                fail(f"flat1m path: {what} ({name}) was launched no time")
        print(f"flat1m bf16 inserts: 2,048 rows linked in {ins_s:.3f} s "
              f"({2048 / ins_s:.1f} vectors/s), {rank1:.4f} found at rank "
              f"1 ({card})", flush=True)
        print(f"flat1m: launches { {k: counts[k] for k in path} }",
              flush=True)

        # ---- kernels against their plain versions at these shapes
        flat1m_kernel_checks(torch, h, queries, bq, fresh, counts, results,
                             launch_of)
    finally:
        for key, v in saved.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        limits.FLAT_THRESHOLD = old_thr
        store.release_mirror()
        h.fused._dev = h.fused._key = None
        gc.collect()
        torch.cuda.empty_cache()
    perf.update(
        turbo_search_p50_ms=turbo["p50_ms"], turbo_batched_qps=turbo["qps"],
        turbo_pipelined_qps=turbo["pipelined_qps"],
        turbo_recall_at_10=turbo["recall"],
        turbo_recall_at_10_after_deletes=turbo_rec2,
        turbo_filtered_recall_at_10=rec_f, flat1m_oracle_s=oracle_s,
        bf16_mirror_bytes=mirror_bytes, bf16_cold_prewarm_first_search_s=cold_s,
        bf16_insert_vectors_per_s=2048 / ins_s, bf16_insert_rank1=rank1,
        **{f"bf16_{tag}_{key}": v for tag, r in bf16.items()
           for key, v in r.items() if key not in ("rows", "dists")})


def k9_fma_check(torch, tp, xf, sq_f, mem, q128, ov):
    """K9 on f32 rows on l2_tile.cuh's FMA pass (rows 4 bytes off a 16-byte
    boundary, which TMA cannot read in place; odd D takes it too) at the
    turbo batch's shape ("approx_topk_f32"), held to its plain version."""
    from fabstir_vectordb_tpu_torch.utils import native

    n, d = xf.shape
    xu = torch.empty(n * d + 1, device=xf.device)[1:].view(n, d)
    xu.copy_(xf)
    before = native.launches["approx_topk_f32"]
    vk, rk = tp.approx_topk(xu, sq_f, mem, q128, ov)
    launched = native.launches["approx_topk_f32"] - before
    if launched != 1:
        fail(f"approx_topk_f32: {launched} launches of the FMA pass")
    vp, rp = tp.approx_topk_plain(xf, sq_f, mem, q128, ov)
    tol = 1e-5 * float(sq_f.max() + (q128 * q128).sum(1).max())
    err, share = pool_check("approx_topk_f32[B=128]", vk, rk, vp, rp, tol)
    b, n_in = q128.shape[0], int(mem.sum())
    bms, by = bound(n * (d * 4 + 4 + 1) + b * d * 4 + b * ov * 8,
                    2.0 * b * n_in * d)
    ROUTE_CHECKS["approx_topk_f32[B=128]"] = dict(
        shape=f"B={b} N={n} D={d} ov_k={ov} rows 4 bytes off 16",
        launches_in_check=launched, max_abs_err=err, tol=tol,
        pool_overlap_with_plain=share,
        ms=cuda_ms(torch, lambda: tp.approx_topk(xu, sq_f, mem, q128, ov)),
        bound_ms=bms, bound_by=by)
    del xu


def flat1m_kernel_checks(torch, h, queries, bq, fresh, counts, results,
                         launch_of):
    """K9, K1 on bf16 rows (query rounded, B = 128 and 1; and unrounded at
    the link shape), K2 on f32 rows, the bf16 re-score composition, K4 and
    K5 on bf16 rows against their plain versions, on the 1M store's
    mirrors; each entry names its pass (tile_pass) and, with the query
    rounded, the time of a bf16 torch.matmul of the same product
    (gemm_ms)."""
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils.transfer import to_device

    store = h.store
    cap, count = store.capacity, store.count
    dev = store.torch_device
    xb, sq_host = store._mirror.x, store._mirror.x_sq  # the bf16 mirror
    xf = torch.empty((cap, xb.shape[1]), dtype=torch.float32, device=dev)
    for lo in range(0, cap, 262_144):  # the f32 mirror beside it
        xf[lo:lo + 262_144] = to_device(store.data[lo:lo + 262_144], dev)
    sq_f = (xf * xf).sum(1)
    d = xf.shape[1]
    mem = torch.zeros(cap, dtype=torch.bool, device=dev)
    mem[:count] = to_device(store.active_mask(count) & (
        h.hnsw.member_mask(count) | h.ivf.member_mask(count)), dev)
    n_in = int(mem.sum())
    q128 = torch.from_numpy(np.concatenate([queries, bq[0][:28]])).to(dev)
    ov = 128

    # K9 on f32 and bf16 rows, one query and 128
    for dt, x, x_sq in (("f32", xf, sq_f), ("bf16", xb, sq_host)):
        rq = dt == "bf16"
        elem = x.element_size()
        for b in (1, 128):
            q = q128[:b].contiguous()
            vk, rk = tp.approx_topk(x, x_sq, mem, q, ov, round_query=rq)
            vp, rp = tp.approx_topk_plain(x, x_sq, mem, q, ov,
                                          round_query=rq)
            key = f"approx_topk[{dt} B={b}]"
            tol = 1e-5 * float(x_sq.max() + (q * q).sum(1).max())
            err, share = pool_check(key, vk, rk, vp, rp, tol)
            _, re = tp.l2_topk(x, x_sq, mem, q, ov, round_query=rq)
            pool_rec = overlap(rk.cpu().numpy(), re.cpu().numpy())
            rec10 = float(np.mean([
                len(set(a.tolist()) & set(e[:10].tolist())) / 10
                for a, e in zip(rk.cpu().numpy(), re.cpu().numpy())]))
            route = tp.tile_route(x.dtype, rq, d)
            nbytes = cap * (d * elem + 4 + 1) + b * d * 4 + b * ov * 8
            bms, by = route_bound(nbytes, 2.0 * b * n_in * d, route)
            results[key] = dict(
                shape=f"B={b} N={cap} D={d} ov_k={ov} bins="
                      f"{tp.approx_bins(cap, ov)} members={n_in}",
                max_abs_err=err, tol=tol, pool_overlap_with_plain=share,
                pool_recall_vs_exact_pool=pool_rec,
                exact_top10_in_pool=rec10,
                ms=cuda_ms(torch, lambda: tp.approx_topk(
                    x, x_sq, mem, q, ov, round_query=rq)),
                plain_ms=cuda_ms(torch, lambda: tp.approx_topk_plain(
                    x, x_sq, mem, q, ov, round_query=rq), iters=2, warmup=1),
                library_ms=None, bound_ms=bms, bound_by=by, tile_pass=route,
                bound_fma_ms=bound(nbytes, 2.0 * b * n_in * d)[0],
                gemm_ms=gemm_ms(torch, q, xb) if rq else None)
            launch_of[key] = counts["approx_topk" if rq else
                                    "approx_topk_tf32"]
    k9_fma_check(torch, tp, xf, sq_f, mem, q128, ov)

    # K1 serving the bf16 mirror, the query rounded, at k 16, 128, 1,024,
    # and at B = 1 with k = 128 (the single refine search's pool)
    for b, k in ((128, 16), (128, 128), (128, 1024), (1, 128)):
        q = q128[:b].contiguous()
        vk, rk = tp.l2_topk(xb, sq_host, mem, q, k, round_query=True)
        vp, rp = tp.l2_topk_plain(xb, sq_host, mem, q, k, round_query=True)
        tol = 2e-5 * float(sq_host.max() + (q * q).sum(1).max())
        key = f"l2_topk[bf16 serve k={k}]" if b == 128 else \
            f"l2_topk[bf16 serve B={b} k={k}]"
        err, differ = topk_check(key, vk, rk, vp, rp, tol)
        bms, by = bound(cap * (d * 2 + 4 + 1) + b * d * 4 + b * k * 8,
                        2.0 * b * n_in * d, BF16_FLOPS)
        results[key] = dict(
            shape=f"B={b} N={cap} D={d} k={k} (query rounded, f32 host "
                  f"norms)", max_abs_err=err, tol=tol,
            rows_differing_at_ties=differ,
            ms=cuda_ms(torch, lambda: tp.l2_topk(xb, sq_host, mem, q, k,
                                                 round_query=True)),
            plain_ms=cuda_ms(torch, lambda: tp.l2_topk_plain(
                xb, sq_host, mem, q, k, round_query=True), iters=2,
                warmup=1),
            library_ms=None, bound_ms=bms,
            bound_by=f"{by} (bf16 tensor-core rate)",
            tile_pass=tp.tile_route(xb.dtype, True, d),
            gemm_ms=gemm_ms(torch, q, xb))
        launch_of[key] = counts["l2_topk_bf16_rq"]

    # K2 on f32 rows: the turbo pool of 128 re-scored to k_eff = 16, for
    # 128 queries and for one
    _, pool = tp.approx_topk(xf, sq_f, mem, q128, ov)
    k2_entry(torch, fu, results, "rerank_f32[f32 rows]", xf, q128, pool, 16)
    k2_entry(torch, fu, results, "rerank_f32[f32 rows B=1]", xf,
             q128[:1].contiguous(), pool[:1].contiguous(), 16)
    for key in ("rerank_f32[f32 rows]", "rerank_f32[f32 rows B=1]"):
        launch_of[key] = counts["rerank_f32_rows"]

    # the bf16 re-score composition of the refine mode: K1 (query rounded)
    # to 128, then K2 to 64
    vk, rk = fu.flat_search_rerank(xb, sq_host, mem, q128, 64, 128)
    vp, rp = fu.flat_search_rerank(xb, sq_host, mem, q128, 64, 128,
                                   plain=True)
    tol = 1e-5 * float(vp[torch.isfinite(vp)].max())
    err, differ = topk_check("flat_search_rerank", vk, rk, vp, rp, tol)
    bms, by = bound(cap * (d * 2 + 4 + 1) + 128 * d * 4 + 128 * 64 * 8,
                    2.0 * 128 * n_in * d, BF16_FLOPS)
    results["flat_search_rerank"] = dict(
        shape=f"B=128 N={cap} D={d} ov_k=128 m=64", max_abs_err=err, tol=tol,
        rows_differing_at_ties=differ,
        ms=cuda_ms(torch, lambda: fu.flat_search_rerank(
            xb, sq_host, mem, q128, 64, 128)),
        plain_ms=cuda_ms(torch, lambda: fu.flat_search_rerank(
            xb, sq_host, mem, q128, 64, 128, plain=True), iters=2, warmup=1),
        library_ms=None, bound_ms=bms,
        bound_by=f"{by} (bf16 tensor-core rate)",
        tile_pass=tp.tile_route(xb.dtype, True, d))
    launch_of["flat_search_rerank"] = counts["rerank_f32"]

    # K3: link candidates on the bf16 mirror (f32 query), then K4 on them
    ql = torch.from_numpy(fresh[:1024]).to(dev)
    vk, rk = tp.l2_topk(xb, sq_host, mem, ql, 200)
    vp, rp = tp.l2_topk_plain(xb, sq_host, mem, ql, 200)
    tol = 2e-5 * float(sq_host.max() + (ql * ql).sum(1).max())
    err, differ = topk_check("l2_topk[bf16 candidates]", vk, rk, vp, rp, tol)
    nbytes = cap * (d * 2 + 4 + 1) + 1024 * d * 4 + 1024 * 200 * 8
    route = tp.tile_route(xb.dtype, False, d)
    bms, by = route_bound(nbytes, 2.0 * 1024 * n_in * d, route)
    results["l2_topk[bf16 candidates]"] = dict(
        shape=f"B=1024 N={cap} D={d} k=200 (f32 query, bf16 rows)",
        max_abs_err=err, tol=tol, rows_differing_at_ties=differ,
        ms=cuda_ms(torch, lambda: tp.l2_topk(xb, sq_host, mem, ql, 200),
                   iters=2),
        plain_ms=cuda_ms(torch, lambda: tp.l2_topk_plain(
            xb, sq_host, mem, ql, 200), iters=1, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by, tile_pass=route,
        bound_fma_ms=bound(nbytes, 2.0 * 1024 * n_in * d)[0])
    launch_of["l2_topk[bf16 candidates]"] = counts["l2_topk_bf16"]
    ids, dd = rk[:, :128].contiguous(), vk[:, :128].contiguous()
    kk = hn.heuristic_kept(xb, ids, dd, 32)
    kp = hn.heuristic_kept_plain(xb, ids, dd, 32)
    torch.cuda.synchronize()
    # the candidates sit near each other in a cluster far from the origin
    flips = k4_flips("heuristic_kept[bf16 link]", kk, kp, ids, dd, xb, True)
    results["heuristic_kept[bf16 link]"] = dict(
        shape=f"B=1024 C=128 D={d} m=32 (bf16 rows)",
        max_abs_err=float((kk != kp).any().item()),
        rows_differing_at_ties=flips,
        ms=cuda_ms(torch, lambda: hn.heuristic_kept(xb, ids, dd, 32)),
        plain_ms=cuda_ms(torch, lambda: hn.heuristic_kept_plain(
            xb, ids, dd, 32), iters=2, warmup=1),
        library_ms=None, **k4_bound(hn, xb, ids))
    launch_of["heuristic_kept[bf16 link]"] = counts["heuristic_kept_bf16"]

    # K5: reverse-prune pair distances on bf16 rows with the host norms
    g = torch.Generator(device=dev).manual_seed(6)
    p = 65_536
    t_ids = torch.randint(0, count, (p,), device=dev, generator=g,
                          dtype=torch.int32)
    c_ids = torch.randint(0, count, (p,), device=dev, generator=g,
                          dtype=torch.int32)
    ok = hn.pair_sq_l2(xb, sq_host, t_ids, c_ids)
    op = hn.pair_sq_l2_plain(xb, sq_host, t_ids, c_ids)
    err = float((ok - op).abs().max())
    tol = 2e-5 * float(2 * sq_host.max())
    if err > tol:
        fail(f"pair_sq_l2[bf16]: max_abs_err {err} > {tol}")
    bms, by = bound(p * (2 * d * 2 + 8 + 8 + 4), p * 2.0 * d)
    results["pair_sq_l2[bf16]"] = dict(
        shape=f"P={p} D={d} (bf16 rows, f32 host norms)", max_abs_err=err,
        tol=tol,
        ms=cuda_ms(torch, lambda: hn.pair_sq_l2(xb, sq_host, t_ids, c_ids)),
        plain_ms=cuda_ms(torch, lambda: hn.pair_sq_l2_plain(
            xb, sq_host, t_ids, c_ids)), library_ms=None, bound_ms=bms,
        bound_by=by)
    launch_of["pair_sq_l2[bf16]"] = counts["pair_sq_l2_bf16"]
    del xf, sq_f
    for name in ("approx_topk[f32 B=1]", "approx_topk[f32 B=128]",
                 "approx_topk[bf16 B=1]", "approx_topk[bf16 B=128]",
                 "l2_topk[bf16 serve k=16]", "l2_topk[bf16 serve k=128]",
                 "l2_topk[bf16 serve k=1024]",
                 "l2_topk[bf16 serve B=1 k=128]", "rerank_f32[f32 rows]",
                 "rerank_f32[f32 rows B=1]", "flat_search_rerank",
                 "l2_topk[bf16 candidates]",
                 "heuristic_kept[bf16 link]", "pair_sq_l2[bf16]"):
        print_kernel(name, results[name], launch_of[name])


ENGINES_KNOBS = ("FVDB_SERVING_DTYPE", "FVDB_PCA_SERVE", "FVDB_FLAT_THRESHOLD")


def metric_exact64(torch, x, x_sq, mask, q, metric: str, k: int,
                   round_query: bool = False):
    """A float64 brute force by metric over the device rows x (upcast),
    with the norms x_sq (the mixed formula of a bf16 mirror: its f32 host
    norms) and the query (rounded to bf16 in the product with
    ``round_query``); 128 queries at a time. Returns (dists, rows) numpy."""
    out_d, out_r = [], []
    x64 = x.double()
    sq64 = x_sq.double()
    for lo in range(0, q.shape[0], 128):
        qq = q[lo:lo + 128]
        qp = (qq.to(torch.bfloat16) if round_query else qq).double()
        dots = qp @ x64.T
        q_sq = (qq.double() ** 2).sum(1)
        if metric == "euclidean":
            dd = q_sq[:, None] - 2.0 * dots + sq64[None, :]
        elif metric == "cosine":
            dd = 1.0 - dots / (q_sq[:, None] * sq64[None, :]).clamp_min(
                1e-30).sqrt()
        else:
            dd = -dots
        dd[:, ~mask] = float("inf")
        v, r = torch.topk(dd, k, largest=False)
        out_d.append(v.cpu().numpy())
        out_r.append(r.cpu().numpy())
        del dots, dd
    del x64
    return np.concatenate(out_d), np.concatenate(out_r)


def engines_phase(torch, native, card: str, perf: dict, results: dict,
                  launch_of: dict, ctx: dict, trace=False,
                  out_dir="smoke_out"):
    """The graph and list engines at every row type and metric on the 1M
    index: the pruned regime on a bf16 mirror (FVDB_SERVING_DTYPE=bfloat16,
    FVDB_PCA_SERVE=0, flat threshold 0) with its recall against the exact
    f32 answers and against a float64 brute force over the bf16-stored
    rows, a filtered batch, 1,000 deletes, the standalone engines, 2,048
    inserts through the layer-0 plan; 2,048 inserts through the per-layer
    plan on each mirror; FlatIndex and IVFIndex by metric (cosine, dot)
    on each mirror. The counters must show K10, K11 at layer 0 and above,
    K12 and K1 on bf16 rows and by metric; then those against their plain
    versions on this state."""
    import gc

    from fabstir_vectordb_tpu_torch.index import tiered as ti
    from fabstir_vectordb_tpu_torch.index.flat import FlatIndex
    from fabstir_vectordb_tpu_torch.utils import limits
    from fabstir_vectordb_tpu_torch.utils.transfer import to_device

    h, centers, cfg, d = ctx["h"], ctx["centers"], ctx["cfg"], ctx["d"]
    store = h.store
    cap = store.capacity
    saved = {key: os.environ.get(key) for key in ENGINES_KNOBS}
    old_thr = limits.FLAT_THRESHOLD
    rng = np.random.default_rng(2207)

    def mode(dtype: str) -> None:  # the pruned regime on this mirror
        os.environ.update(FVDB_SERVING_DTYPE=dtype, FVDB_PCA_SERVE="0",
                          FVDB_FLAT_THRESHOLD="0")
        limits.FLAT_THRESHOLD = 0
        info = h.fused.serving_info()
        if info["regime"] != "pruned" or info["serving_dtype"] != dtype:
            fail(f"engines: serving_info {info} for {dtype}")

    def members_now():
        count = store.count
        live = store.active_mask(count)
        hm = live & h.hnsw.member_mask(count)
        return hm, live & h.ivf.member_mask(count) & ~hm

    hm0, im0 = members_now()
    hnsw_rows, ivf_rows = np.nonzero(hm0)[0], np.nonzero(im0)[0]

    def noisy(rows):
        return (store.data[rows] + 0.3 * rng.standard_normal(
            (len(rows), d))).astype(np.float32)

    def from_both(m):  # half near HNSW rows, half near IVF rows
        return np.concatenate([rng.choice(hnsw_rows, m // 2),
                               rng.choice(ivf_rows, m - m // 2)])

    def fresh(m):  # new recent rows around the corpus's centers
        return (centers[rng.integers(0, len(centers), m)]
                + 0.35 * rng.standard_normal((m, d))).astype(np.float32)

    def search(qq, k=10, **kw):
        return h.search_rows(qq, k, cfg, now=NOW, **kw)

    qs, qb = noisy(from_both(256)), noisy(from_both(1024))
    fmask = np.arange(cap) % 10 == 3
    out = {}
    native.reset_launches()
    try:
        # ---- 1. the pruned regime on a bf16 mirror
        mode("bfloat16")
        t = time.perf_counter()
        search(qs[:1])
        state_s = time.perf_counter() - t
        m = store._mirror
        mirror_bytes = m.x.numel() * m.x.element_size()
        if m.x.dtype != torch.bfloat16 or mirror_bytes * 2 != cap * d * 4:
            fail(f"engines: the serving mirror is {m.x.dtype}, "
                 f"{mirror_bytes} bytes")
        lat, single = [], []
        for q in qs:
            t = time.perf_counter()
            single.append(search(q[None])[1][0])
            lat.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        batched = [search(qb[i * 128:(i + 1) * 128])[1] for i in range(8)]
        batch_s = time.perf_counter() - t
        single, batched = np.stack(single), np.concatenate(batched)
        members = hm0 | im0
        oracle = ti.TieredFlatSearcher(store.data[:store.count], members,
                                       device=store.torch_device)
        t = time.perf_counter()
        _, ex = oracle.search(np.concatenate([qs, qb]), 10)
        oracle_s = time.perf_counter() - t
        rec_f32 = (recall(single, ex[:256]), recall(batched, ex[256:]))
        if min(rec_f32) < 0.85:
            fail(f"engines bf16 pruned recall@10 against the exact f32 "
                 f"answers {rec_f32} < 0.85")
        mem = torch.zeros(cap, dtype=torch.bool, device=m.x.device)
        mem[:store.count] = to_device(members, m.x.device)
        qall = torch.from_numpy(np.concatenate([qs, qb])).to(m.x.device)
        xs = m.x.float()
        _, stored = metric_exact64(torch, m.x, (xs * xs).sum(1), mem, qall,
                                   "euclidean", 10)
        del xs
        rec_stored = (recall(single, stored[:256]),
                      recall(batched, stored[256:]))
        if min(rec_stored) < 0.95:
            fail(f"engines bf16 pruned recall@10 against the bf16-stored "
                 f"rows {rec_stored} < 0.95")
        _, rf = search(qb[:128], extra_mask=fmask)
        if (rf < 0).any() or not fmask[rf].all():
            fail("engines bf16 pruned: a filtered-out row was returned")
        top = [int(r) for row in single[:50] for r in row[:5] if r >= 0]
        dead = list(dict.fromkeys([h.hnsw.entry_point] + top + rng.choice(
            np.nonzero(members)[0], 1200).tolist()))[:1000]
        if h.batch_delete([store.id_of(r) for r in dead]) != 1000:
            fail("engines: batch_delete")
        after = np.concatenate([search(qs[:128])[1], search(qb[:128])[1],
                                search(qb[:128], extra_mask=fmask)[1]])
        if np.isin(after, dead).any():
            fail("engines bf16 pruned: a deleted row was returned")
        hm1, im1 = members_now()
        _, rh = h.hnsw.search_rows(qs[:128], 10)
        _, ri = h.ivf.search_rows(qs[:128], 10)
        for tag, r, mm in (("hnsw", rh, hm1), ("ivf", ri, im1)):
            if (r < 0).any() or not mm[r].all():
                fail(f"engines bf16 standalone {tag}: a row outside its "
                     f"engine's live members")
        if store._mirror.x.dtype != torch.bfloat16:
            fail("engines: the standalone engines left the bf16 mirror")
        before = {k: native.launches[k] for k in (
            "greedy_descent_bf16", "beam_search_bf16", "l2_topk_bf16")}
        new = fresh(2048)
        t = time.perf_counter()
        new_rows = h.insert_batch([f"e0-{i}" for i in range(2048)], new,
                                  np.full(2048, NOW - DAY), now=NOW)
        torch.cuda.synchronize()
        link0_s = time.perf_counter() - t
        if native.launches["greedy_descent_bf16"] == before[
                "greedy_descent_bf16"] or native.launches[
                "beam_search_bf16"] == before["beam_search_bf16"] \
                or native.launches["l2_topk_bf16"] != before["l2_topk_bf16"]:
            fail("engines: the 2,048 bf16 inserts did not link through the "
                 "layer-0 plan")
        rank1_0 = float((search(new, 1)[1][:, 0] == new_rows).mean())
        if rank1_0 < 0.99:
            fail(f"engines: layer-0 plan inserts on bf16 at rank 1: "
                 f"{rank1_0} < 0.99")
        p50 = float(np.percentile(lat, 50))
        out.update(
            bf16_pruned_state_build_s=state_s, bf16_pruned_search_p50_ms=p50,
            bf16_pruned_batched_qps=1024 / batch_s,
            bf16_pruned_recall_at_10_f32=rec_f32,
            bf16_pruned_recall_at_10_stored=rec_stored,
            bf16_mirror_bytes=mirror_bytes, engines_oracle_s=oracle_s,
            bf16_layer0_link_s=link0_s, bf16_layer0_rank1=rank1_0)
        print(f"engines bf16 pruned: p50 {p50:.3f} ms over 256 single k=10 "
              f"searches, {1024 / batch_s:.1f} QPS over 8 x 128; recall@10 "
              f"against the exact f32 answers {rec_f32[0]:.4f} / "
              f"{rec_f32[1]:.4f} (single / batched), against the "
              f"bf16-stored rows {rec_stored[0]:.4f} / {rec_stored[1]:.4f}; "
              f"mirror {mirror_bytes / 1e9:.3f} GB; state {state_s:.3f} s; "
              f"filtered, 1,000 deletes and the standalone engines clean; "
              f"2,048 layer-0 inserts in {link0_s:.3f} s, {rank1_0:.4f} at "
              f"rank 1 ({card})", flush=True)
        if trace:
            for name, fn in (
                    ("bf16_pruned_single", lambda: [search(q[None])
                                                    for q in qs[:64]]),
                    ("bf16_pruned_batched", lambda: [search(
                        qb[i * 128:(i + 1) * 128]) for i in range(4)])):
                wall, dev_ms = device_trace(torch, name, fn, out_dir)
                print(f"trace {name}: wall {wall:.3f} ms, device "
                      f"{dev_ms:.3f} ms, busy share {dev_ms / wall:.3f} "
                      f"({card})", flush=True)

        # ---- 2. the per-layer link plan on each mirror
        h.hnsw.config.link_mode = "per_layer"
        for dtype in ("bfloat16", "float32"):
            mode(dtype)
            up = native.counter("beam_search", dtype == "bfloat16", up=True)
            b_up = native.launches[up]
            new = fresh(2048)
            t = time.perf_counter()
            new_rows = h.insert_batch(
                [f"pl-{dtype}-{i}" for i in range(2048)], new,
                np.full(2048, NOW - DAY), now=NOW)
            torch.cuda.synchronize()
            s = time.perf_counter() - t
            if native.launches[up] == b_up:
                fail(f"engines per-layer ({dtype}): K11 never ran above "
                     f"layer 0")
            r1 = float((search(new, 1)[1][:, 0] == new_rows).mean())
            if r1 < 0.99:
                fail(f"engines per-layer inserts ({dtype}) at rank 1: "
                     f"{r1} < 0.99")
            out[f"per_layer_{dtype}_link_s"] = s
            out[f"per_layer_{dtype}_rank1"] = r1
            print(f"engines per-layer ({dtype}): 2,048 inserts linked in "
                  f"{s:.3f} s ({2048 / s:.1f} vectors/s), {r1:.4f} at rank "
                  f"1, K11 above layer 0 {native.launches[up] - b_up} "
                  f"launches ({card})", flush=True)
        h.hnsw.config.link_mode = "auto"

        # ---- 3. FlatIndex and IVFIndex by metric, on each mirror
        qm = qb[:128]
        for dtype in ("float32", "bfloat16"):
            mode(dtype)
            _, im2 = members_now()
            live = store.active_mask(store.count)
            bf = dtype == "bfloat16"
            for metric in ("cosine", "dot"):
                tag = f"engines {metric} ({dtype})"
                fi = FlatIndex(store, metric=metric)
                dk, rk = fi.search_rows(qm, 10)
                fi.search_rows(qm[:4], 300)  # the k > 256 path
                mm = store._mirror
                dv, n_rows = mm.x.device, mm.x.shape[0]
                mem = torch.zeros(n_rows, dtype=torch.bool, device=dv)
                mem[:store.count] = to_device(live, dv)
                ivm = torch.zeros(n_rows, dtype=torch.bool, device=dv)
                ivm[:store.count] = to_device(im2, dv)
                qd = torch.from_numpy(qm).to(dv)
                scale = 1.0 if metric == "cosine" else float(
                    np.linalg.norm(qm, axis=1).max()
                    * np.sqrt(float(mm.x_sq.max())))
                # the flat index: the float64 brute force of its formula
                # (on a bf16 mirror: the rounded query and bf16 rows in the
                # product, the f32 host norms)
                d64, r64 = metric_exact64(torch, mm.x, mm.x_sq, mem, qd,
                                          metric, 10, round_query=bf)
                if bf:
                    ov = overlap(rk, r64)
                    if ov < 0.99:
                        fail(f"{tag} flat: overlap {ov} with the float64 "
                             f"mixed formula < 0.99")
                else:
                    topk_check(f"{tag} flat", torch.from_numpy(dk),
                               torch.from_numpy(rk), torch.from_numpy(
                                   d64.astype(np.float32)),
                               torch.from_numpy(r64.astype(np.int32)),
                               1e-5 * scale)
                    ov = overlap(rk, r64)
                # the IVF at every probe: the flat index over its members
                # (on a bf16 mirror the IVF keeps the f32 query, so its
                # reference is the float64 brute force of that formula)
                du, ru = h.ivf.search_rows(qm, 10, n_probe=256,
                                           metric=metric)
                if bf:
                    _, ref = metric_exact64(torch, mm.x, mm.x_sq, ivm, qd,
                                            metric, 10)
                    ov_ivf = overlap(ru, ref)
                    if ov_ivf < 0.99:
                        fail(f"{tag} IVF at 256 probes: overlap {ov_ivf} "
                             f"with the float64 brute force < 0.99")
                else:
                    ivf_mem = np.zeros(n_rows, bool)
                    ivf_mem[:store.count] = im2
                    dfl, ref = fi.search_rows(qm, 10, extra_mask=ivf_mem)
                    topk_check(f"{tag} IVF at 256 probes", torch.from_numpy(
                        du), torch.from_numpy(ru), torch.from_numpy(dfl),
                        torch.from_numpy(ref), 1e-5 * scale)
                    ov_ivf = overlap(ru, ref)
                _, r16 = h.ivf.search_rows(qm, 10, n_probe=16, metric=metric)
                rec16 = recall(r16, ref)
                out.update({f"{metric}_{dtype}_flat_overlap_f64": ov,
                            f"{metric}_{dtype}_ivf_all_probes_overlap": ov_ivf,
                            f"{metric}_{dtype}_ivf_recall_at_10_nprobe16":
                                rec16})
                print(f"{tag}: flat answers against the float64 brute force "
                      f"{'overlap' if bf else 'equal up to ties, overlap'} "
                      f"{ov:.4f}; IVF at 256 probes overlap {ov_ivf:.4f} "
                      f"with the exact answer over its members; IVF at 16 "
                      f"probes recall@10 {rec16:.4f} ({card})", flush=True)
        torch.cuda.synchronize()
        counts = dict(native.launches)
        note_shapes("engines-1m", native)
        path = {"greedy_descent_bf16": "K10 on bf16 rows",
                "beam_search_bf16": "K11 on bf16 rows",
                "beam_search_bf16_up": "K11 above layer 0, bf16 rows",
                "beam_search_up": "K11 above layer 0, f32 rows",
                "ivf_scan_bf16": "K12 on bf16 rows",
                "l2_topk_cosine": "K1 cosine", "l2_topk_dot": "K1 dot",
                "l2_topk_large_cosine": "K1 cosine at k > 256",
                "l2_topk_large_dot": "K1 dot at k > 256",
                "l2_topk_bf16_rq_cosine": "K1 cosine on bf16 rows",
                "l2_topk_bf16_rq_dot": "K1 dot on bf16 rows",
                "ivf_scan_cosine": "K12 cosine", "ivf_scan_dot": "K12 dot",
                "ivf_scan_bf16_cosine": "K12 cosine on bf16 rows",
                "ivf_scan_bf16_dot": "K12 dot on bf16 rows",
                "heuristic_kept_bf16": "K4 on bf16 rows"}
        for name, what in path.items():
            if counts[name] <= 0:
                fail(f"engines path: {what} ({name}) was launched no time")
        print(f"engines: launches { {k: counts[k] for k in path} }",
              flush=True)

        # ---- 4. kernels against their plain versions on this state
        mode("bfloat16")
        search(qs[:1])  # the bf16 state after the f32 inserts
        engines_kernel_checks(torch, h, qb, fresh(1024), counts, results,
                              launch_of)
    finally:
        h.hnsw.config.link_mode = "auto"
        for key, v in saved.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        limits.FLAT_THRESHOLD = old_thr
        store.release_mirror()
        h.fused._dev = h.fused._key = None
        gc.collect()
        torch.cuda.empty_cache()
    perf.update(out)


def ivf_work(lists, mask, probe, b: int, k: int, d: int, elem: int):
    """(bytes, flops, pairs, distinct rows) of a K12 call: every (query,
    probed list) scores the list's rows that pass the mask (the flops),
    but a bound reads each probed list once."""
    tl = lists.tiles
    live = ((tl >= 0) & mask[tl.clamp_min(0).long()]).sum(1)
    pairs = int(live[probe.long()].sum())
    union = probe.long().unique()
    rows_once = int(live[union].sum())
    entries_once = int(lists.list_len[union].sum())
    n_c = int(lists.centroids.shape[0])
    nbytes = (rows_once * (d * elem + 4) + entries_once * (4 + 1)
              + n_c * d * 4 + b * d * 4 + b * k * 8)
    return nbytes, 2.0 * d * (pairs + b * n_c), pairs, rows_once


def k12_reads(torch, lists, mask, probe, d: int, elem: int, c_lo: int = 0,
              grouped: bool = True) -> dict:
    """The list rows K12 reads for ``probe`` as modelled from the probes,
    not counted on the card: each probed list's live rows once a group of
    up to GROUP_QT of its queries (the grouped route) or once a query (the
    per-query route), beside the distinct live rows a bound counts, as
    rows and bytes. The model leaves out L2 hits, the tiles, the row ids
    and the queries."""
    from fabstir_vectordb_tpu_torch.index import ivf as iv

    tl = lists.tiles
    c = tl.shape[0]
    live = ((tl >= 0) & mask[tl.clamp_min(0).long()]).sum(1)
    loc = probe.long() - c_lo
    own = (loc >= 0) & (loc < c)
    cnt = torch.bincount(loc[own], minlength=c)
    per = (cnt + iv.GROUP_QT - 1) // iv.GROUP_QT if grouped else cnt
    rows = int((live * per).sum())
    distinct = int(live[cnt > 0].sum())
    return {"rows_read": rows, "bytes_read": rows * d * elem,
            "distinct_rows": distinct, "distinct_bytes": distinct * d * elem}


def k12_stage_us(torch, fn, reps: int = 5) -> dict:
    """Device microseconds a K12 call ``fn`` spends in each stage, from
    torch.profiler's kernel records over ``reps`` calls (means): the work
    list (ivf_group_kernel, the grouped route), the list scan
    (ivf_tasks_kernel, or ivf_scan_kernel on the per-query route) and the
    selection (every other kernel and memset of the call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {"group": 0.0, "scan": 0.0, "select": 0.0}
    kernels = 0
    for e in p.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kernels += 1
        stage = ("group" if "ivf_group_kernel" in e.name else
                 "scan" if "ivf_tasks_kernel" in e.name
                 or "ivf_scan_kernel" in e.name else "select")
        us[stage] += e.time_range.elapsed_us() / reps
    if kernels == 0:
        return {"not measured": "the profiler recorded no device activity"}
    return {**us, "route": "grouped" if us["group"] else "per-query"}


def engines_kernel_checks(torch, h, qb, ql_np, counts, results, launch_of):
    """K10, K11 (serve, link, above layer 0) and K13 on bf16 rows, K12 on
    bf16 rows and by metric, K1 by metric on f32 and bf16 rows, and
    chunked_topk with negative distances at k 10 (the fused chunk step),
    300 and 1,024 (the filtered select: a bar, survivors, a sort and a
    merge by binary search), against their plain versions on the 1M
    index's state."""
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.index import ivf as iv
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import limits, native
    from fabstir_vectordb_tpu_torch.utils.transfer import to_device

    store = h.store
    st = h.fused._device_state(pruned=True)
    xb, sq = st["x"], st["x_sq"]  # the bf16 mirror, the f32 host norms
    if xb.dtype != torch.bfloat16:
        fail("engines checks: the state is not on the bf16 mirror")
    dev = xb.device
    cap, d = xb.shape
    xf = torch.empty((cap, d), dtype=torch.float32, device=dev)
    for lo in range(0, cap, 262_144):  # the f32 mirror beside it
        xf[lo:lo + 262_144] = to_device(store.data[lo:lo + 262_144], dev)
    sq_f = (xf * xf).sum(1)
    qd = torch.from_numpy(qb[:128]).to(dev)
    ql = torch.from_numpy(ql_np).to(dev)
    q_bytes = 128 * d * 4
    hm, im, mem = st["hnsw_mask"], st["ivf_mask"], st["members"]
    nbrs0, nbrs_up, up_off = st["nbrs0"], st["nbrs_up"], st["up_offset"]
    entry, level = st["entry"], st["entry_level"]
    m_up = int(nbrs_up.shape[1])
    work = {}
    names = []

    # K10 on bf16 rows, at B = 128 and one query
    gargs = (xb, sq, hm, nbrs_up, up_off, qd, entry, level)
    shape = f"M={m_up} D={d} levels={level} (bf16 rows)"
    work["greedy_descent[bf16]"] = k10_entry(
        torch, hn, results, "greedy_descent[bf16]", gargs, f"B=128 {shape}")
    k10_entry(torch, hn, results, "greedy_descent[bf16 B=1]",
              gargs[:5] + (qd[:1],) + gargs[6:], f"B=1 {shape}")
    ck = hn.greedy_descent(*gargs)[0]
    for key in ("greedy_descent[bf16]", "greedy_descent[bf16 B=1]"):
        launch_of[key] = counts["greedy_descent_bf16"]
        names.append(key)

    # K11: serve, layer-0 link, and one layer of the per-layer plan (the
    # queries below it inactive), on bf16 rows; that layer on f32 rows too
    ex_h = tp.l2_topk(xb, sq, hm, qd, 10)[1].cpu().numpy()
    cl, _ = hn.greedy_descent(xb, sq, hm, nbrs_up, up_off, ql, entry, level)
    layer = min(2, level)
    stop_np = np.minimum(np.random.default_rng(3).integers(0, 4, ql.shape[0]),
                         level).astype(np.int32)
    stop = torch.from_numpy(stop_np).to(dev)
    act = torch.from_numpy(stop_np >= layer).to(dev)
    cu_b, _ = hn.greedy_descent(xb, sq, hm, nbrs_up, up_off, ql, entry,
                                level, stop)
    cu_f, _ = hn.greedy_descent(xf, sq_f, hm, nbrs_up, up_off, ql, entry,
                                level, stop)
    for tag, x, x_sq, qq, start, active, lay, ef, w, exact in (
            ("bf16 serve", xb, sq, qd, ck, None, 0, 64, limits.beam_expand(),
             ex_h),
            ("bf16 serve B=1", xb, sq, qd[:1], ck[:1], None, 0, 64,
             limits.beam_expand(), ex_h[:1]),
            ("bf16 link", xb, sq, ql, cl, None, 0, 200, 1, None),
            ("bf16 upper layer", xb, sq, ql, cu_b, act, layer, 200, 1, None),
            ("upper layer", xf, sq_f, ql, cu_f, act, layer, 200, 1, None)):
        key = f"beam_search[{tag}]"
        args = (x, x_sq, hm, nbrs0, nbrs_up, up_off, qq,
                start[:, None].contiguous(), active, lay, ef, ef + 32, None,
                None, w)
        bk, ik = hn.beam_search(*args)
        bst = {}
        bp, ip = hn.beam_search_plain(*args, stats=bst)
        on = torch.ones(qq.shape[0], dtype=torch.bool, device=dev) \
            if active is None else active
        if not torch.equal(ik[~on], ip[~on]):
            fail(f"{key}: an inactive query's starts differ")
        ik_n, ip_n = ik[on].cpu().numpy(), ip[on].cpu().numpy()
        ov = overlap(ik_n, ip_n)
        if ov < 0.99:
            fail(f"{key}: overlap {ov} with plain < 0.99")
        rk = rp = None
        if exact is not None:
            rk, rp = recall(ik_n, exact), recall(ip_n, exact)
            if abs(rk - rp) > 0.005:
                fail(f"{key}: recall@10 {rk} vs plain {rp}")
        both = (ik == ip) & (ik >= 0)
        b = qq.shape[0]
        seen = int(bst["seen"].sum())
        elem = x.element_size()
        work[key] = (seen * (d * elem + 4 + 1) + bst["parents"] * 32 * 4
                     + b * d * 4 + b * ef * 8, bst["rows"] * 2.0 * d)
        bms, by = bound(*work[key])
        results[key] = dict(
            shape=f"B={b} ef={ef} W={w} layer={lay} active="
                  f"{int(on.sum())} D={d} ({'bf16' if elem == 2 else 'f32'}"
                  f" rows)",
            max_abs_err=float((bk - bp)[both].abs().max()) if both.any()
            else 0.0, overlap=ov, recall_at_10=rk, plain_recall_at_10=rp,
            steps=bst["steps"], steps_max=bst["steps_max"], rows=bst["rows"],
            distinct_rows=seen, warps_a_query=hn.beam_plan(
                b, w, 32 if lay == 0 else int(nbrs_up.shape[1])),
            ms=cuda_ms(torch, lambda: hn.beam_search(*args)),
            plain_ms=cuda_ms(torch, lambda: hn.beam_search_plain(*args),
                             iters=2, warmup=1),
            library_ms=None, bound_ms=bms, bound_by=by)
        launch_of[key] = counts[native.counter(
            "beam_search", elem == 2, up=lay > 0)]
        names.append(key)

    # K12 on bf16 rows and by metric; its probes are K1 of the metric
    lists = st["ivf"]
    q_sq_max = float((qd * qd).sum(1).max())
    for tag, x, x_sq, metric in (("bf16", xb, sq, "euclidean"),
                                 ("cosine", xf, sq_f, "cosine"),
                                 ("dot", xf, sq_f, "dot"),
                                 ("bf16 cosine", xb, sq, "cosine"),
                                 ("bf16 dot", xb, sq, "dot")):
        key = f"ivf_scan[{tag}]"
        iargs = (x, x_sq, im, lists, qd, 16, 16)
        vk, rk, pk = iv.ivf_search(*iargs, metric=metric)
        vp, rp, pp = iv.ivf_search_plain(*iargs, metric=metric)
        probes = float((pk == pp).float().mean())
        if probes < 0.99:
            fail(f"{key}: {probes} of the probed lists agree with plain")
        tol = 1e-5 * {"euclidean": float(x_sq.max()) + q_sq_max,
                      "cosine": 1.0,
                      "dot": (float(x_sq.max()) * q_sq_max) ** 0.5}[metric]
        err, share = pool_check(key, vk, rk, vp, rp, tol)
        elem = x.element_size()
        nbytes, flops, pairs, rows_once = ivf_work(lists, im, pk, 128, 16, d,
                                                   elem)
        bms, by = bound(nbytes, flops)
        results[key] = dict(
            shape=f"B=128 C={lists.centroids.shape[0]} n_probe=16 k=16 "
                  f"{metric} ({'bf16' if elem == 2 else 'f32'} rows) "
                  f"(query, row) pairs={pairs} distinct rows={rows_once}",
            max_abs_err=err, tol=tol, overlap=share, probes_agree=probes,
            ms=cuda_ms(torch, lambda: iv.ivf_search(*iargs, metric=metric)),
            plain_ms=cuda_ms(torch, lambda: iv.ivf_search_plain(
                *iargs, metric=metric), iters=2, warmup=1),
            library_ms=None, bound_ms=bms, bound_by=by,
            stage_us=k12_stage_us(torch, lambda: iv.ivf_scan(
                x, x_sq, im, lists, pk, qd, 16, metric=metric)),
            modelled_reads=k12_reads(torch, lists, im, pk, d, elem))
        launch_of[key] = counts[native.counter("ivf_scan", elem == 2,
                                               metric)]
        names.append(key)
        if tag == "bf16":
            work["ivf_scan[bf16]"] = (nbytes, flops)

    # K13 on bf16 rows: K10 -> K11 -> K12
    hy_args = (xb, sq, hm, im, st["ones"], nbrs0, nbrs_up, up_off, entry,
               level, lists, qd, 16, 64, 16, st["has_hnsw"])
    hy_kw = dict(beam_expand=limits.beam_expand())
    hv, hk = fu.hybrid_search(*hy_args, **hy_kw)
    hvp, hp = fu.hybrid_search_plain(*hy_args, **hy_kw)
    ex_all = tp.l2_topk(xb, sq, mem, qd, 10)[1].cpu().numpy()
    hk_n, hp_n = hk.cpu().numpy()[:, :10], hp.cpu().numpy()[:, :10]
    ov = overlap(hk_n, hp_n)
    rk, rp = recall(hk_n, ex_all), recall(hp_n, ex_all)
    if ov < 0.99 or abs(rk - rp) > 0.005:
        fail(f"hybrid_search[bf16]: overlap {ov}, recall@10 {rk} vs plain "
             f"{rp}")
    # squared L2: 1e-5 of the norms the expansion cancels, as K12's
    hy_tol = 1e-5 * (float(sq.max()) + q_sq_max)
    hy_err = shared_err("hybrid_search[bf16]", hv.cpu().numpy(),
                        hk.cpu().numpy(), hvp.cpu().numpy(),
                        hp.cpu().numpy(), hy_tol)
    parts = ("greedy_descent[bf16]", "beam_search[bf16 serve]",
             "ivf_scan[bf16]")
    bms, by = bound(sum(work[p][0] for p in parts),
                    sum(work[p][1] for p in parts))
    results["hybrid_search[bf16]"] = dict(
        shape="B=128 k=16 ef=64 n_probe=16 (bf16 rows; a composition: "
              "K10 + K11 + K12)", max_abs_err=hy_err, tol=hy_tol,
        overlap=ov,
        recall_at_10=rk, plain_recall_at_10=rp,
        ms=cuda_ms(torch, lambda: fu.hybrid_search(*hy_args, **hy_kw)),
        plain_ms=cuda_ms(torch, lambda: fu.hybrid_search_plain(
            *hy_args, **hy_kw), iters=2, warmup=1),
        library_ms=None, bound_ms=bms,
        bound_by=f"{by}: K10 + K11[bf16 serve] + K12[bf16] work")
    launch_of["hybrid_search[bf16]"] = counts["ivf_scan_bf16"]
    names.append("hybrid_search[bf16]")

    # K1 by metric on f32 rows and on bf16 rows (the query rounded)
    n_in = int(mem.sum())
    x_sq_max = float(sq.max())
    for bf in (False, True):
        x, x_sq = (xb, sq) if bf else (xf, sq_f)
        for metric in ("cosine", "dot"):
            for k in (16, 1024):
                key = f"l2_topk[{'bf16 ' if bf else ''}{metric} k={k}]"
                vk, rk = tp.l2_topk(x, x_sq, mem, qd, k, round_query=bf,
                                    metric=metric)
                vp, rp = tp.l2_topk_plain(x, x_sq, mem, qd, k,
                                          round_query=bf, metric=metric)
                tol = 1e-5 * (1.0 if metric == "cosine"
                              else (x_sq_max * q_sq_max) ** 0.5)
                err, share = pool_check(key, vk, rk, vp, rp, tol)
                elem = x.element_size()
                route = tp.tile_route(x.dtype, bf, d)
                bms, by = route_bound(cap * (d * elem + 4 + 1) + q_bytes
                                      + 128 * k * 8, 2.0 * 128 * n_in * d,
                                      route)
                results[key] = dict(
                    shape=f"B=128 N={cap} D={d} k={k} {metric} "
                          f"({'bf16 rows, query rounded' if bf else 'f32'})",
                    max_abs_err=err, tol=tol, overlap=share,
                    ms=cuda_ms(torch, lambda: tp.l2_topk(
                        x, x_sq, mem, qd, k, round_query=bf, metric=metric)),
                    plain_ms=cuda_ms(torch, lambda: tp.l2_topk_plain(
                        x, x_sq, mem, qd, k, round_query=bf, metric=metric),
                        iters=2, warmup=1),
                    library_ms=None, bound_ms=bms, bound_by=by,
                    tile_pass=route)
                launch_of[key] = counts[native.counter(
                    "l2_topk" if bf or k <= 256 else "l2_topk_large", bf,
                    metric, rq=bf)]
                names.append(key)

    # chunked_topk over negative (dot) distances of 32 queries, 8 chunks: at
    # k = 10 the fused step (one launch a chunk), at k = 300 (just past the
    # fused kernel's reach) and 1,024 the filtered select; each held to the
    # plain steps over the same distances exactly
    b, n = 32, cap
    chunk = n // 8
    dall = torch.stack([-(qd[:b] @ xf[lo:lo + chunk].T)
                        for lo in range(0, n, chunk)])  # [8, B, chunk]
    keep = mem.view(8, chunk)
    flat_d = torch.where(keep[:, None, :], dall,
                         torch.full_like(dall, float("inf"))
                         ).permute(1, 0, 2).reshape(b, n).contiguous()

    def dist_fn(start):
        i = start // chunk
        return dall[i], keep[i]

    card = card_line()
    for k in (10, 300, 1024):
        def plain_run():
            vals = torch.full((b, k), float("inf"), device=dev)
            rows = torch.full((b, k), -1, dtype=torch.int32, device=dev)
            for i in range(8):
                vals, rows = tp.chunk_step_plain(dall[i], keep[i], i * chunk,
                                                 vals, rows, k)
            return vals, rows

        key = "chunked_topk" if k == 10 else f"chunked_topk[k={k}]"
        before = native.launches["chunk_step"]
        run = tp.chunked_topk(dist_fn, n, chunk, k, b, device=dev)
        vk, rk = run()
        if native.launches["chunk_step"] - before != 8:
            fail(f"{key}: not one chunk_step call a chunk")
        vp, rp = plain_run()
        if not (vk[:, 0] < 0).all():
            fail(f"{key}: the dot distances are not negative")
        if not (torch.equal(rk, rp) and torch.equal(vk, vp)):
            fail(f"{key}: differs from its plain version")
        # each step's device time (the card kept busy while the host queues
        # them) and the host time of a step
        work = tp.chunk_scratch(b, chunk, min(k, chunk), dev, k)
        sv = [(torch.full((b, k), float("inf"), device=dev),
               torch.full((b, k), -1, dtype=torch.int32, device=dev))]
        sv.append((torch.empty_like(sv[0][0]), torch.empty_like(sv[0][1])))
        steps = [lambda i=i: tp.chunk_step(dall[i], keep[i], i * chunk,
                                           *sv[i % 2], k, sv[(i + 1) % 2],
                                           work) for i in range(8)]
        step_us = device_us_each(torch, steps)
        run_v = torch.full((b, k), float("inf"), device=dev)
        run_r = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        outs = (torch.empty_like(run_v), torch.empty_like(run_r))
        bms, by = bound(b * n * 4 + n + b * k * 8, 0.0)
        results[key] = dict(
            shape=f"B={b} N={n} chunk={chunk} k={k} (dot distances, masked)",
            max_abs_err=0.0,
            ms=cuda_ms(torch, run), plain_ms=cuda_ms(torch, plain_run),
            library_ms=cuda_ms(torch, lambda: torch.topk(flat_d, k,
                                                         largest=False)),
            first_step_us=step_us[0],
            later_step_us=sum(step_us[1:]) / 7,
            step_host_us=host_us(torch, lambda: tp.chunk_step(
                dall[0], keep[0], 0, run_v, run_r, k, outs, work)),
            run_host_us=host_us(torch, run, calls=20),
            bound_ms=bms, bound_by=by)
        print(f"{key} step device us: first {step_us[0]:.1f}, then "
              + " ".join(f"{u:.1f}" for u in step_us[1:]) + "; host us a "
              f"step {results[key]['step_host_us']:.1f} ({card})",
              flush=True)
        launch_of[key] = counts["chunk_step"]
        names.append(key)
    del xf, sq_f, dall, flat_d
    for name in names:
        print_kernel(name, results[name], launch_of[name])


def memory_line(torch) -> str:
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return (f"device peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB, "
            f"host peak RSS {rss / 1e9:.3f} GB")


class StageClock:
    """Seconds spent in named calls: wraps an attribute of an object so
    each call is timed between two device synchronisations."""

    def __init__(self, torch):
        self.torch, self.s, self._undo = torch, {}, []

    def wrap(self, obj, attr: str, name: str) -> None:
        real = getattr(obj, attr)
        own = attr in vars(obj)  # a module's function, not a method

        def timed(*a, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*a, **kw)
            self.torch.cuda.synchronize()
            self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t
            return out

        setattr(obj, attr, timed)
        self._undo.append((obj, attr, real if own else None))

    def undo(self) -> None:
        for obj, attr, real in reversed(self._undo):
            if real is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, real)
        self._undo.clear()


def bf16_ulps(torch, a, b):
    """Per-element distance of two bf16 tensors in bf16 ulps."""
    def order(t):
        u = t.view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - (u & 0x7FFF), 0x8000 + u)
    return (order(a) - order(b)).abs()


def scale_phase(torch, native, card: str, perf: dict, results: dict,
                launch_of: dict, trace=False, out_dir="smoke_out"):
    """bench.py's 10M tier (bench_10m, bench.py:519-796) through the port:
    a procedural corpus of SCALE_ROWS x 384 (K17) registered and filled
    block by block with each block's IVF assignment (K6), the IVF trained
    on the first 10,000 rows, the source spot-checked and attached, then
    the default regime above the flat threshold at bench.py's operating
    point (device stage 2, rank 192, oversample 96) with its mirror made on
    the card by K17: the first search, 100 single and 5 x 128 batched
    searches, recall@10 against the exact f32 oracle streamed by
    TieredFlatSearcher (K1 + K8's merge a tile). Then the regime's
    guarantees and K17, K6, K14, K2 and the tile step against their plain
    versions at this tier's shapes."""
    import gc

    point = {"FVDB_HBM_BUDGET_GB": "14.5", "FVDB_STAGE1_TRANSIENT_GB": "2",
             "FVDB_PCA_RANK": "192", "FVDB_PCA_OVERSAMPLE": "96"}
    cleared = ("FVDB_PCA_SERVE", "FVDB_FLAT_THRESHOLD", "FVDB_PCA_RERANK")
    saved = {key: os.environ.get(key) for key in (*point, *cleared)}
    for key in cleared:
        os.environ.pop(key, None)
    os.environ.update(point)
    torch.cuda.reset_peak_memory_stats()
    try:
        _scale_run(torch, native, card, perf, results, launch_of, trace,
                   out_dir)
    finally:
        for key, v in saved.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        gc.collect()
        torch.cuda.empty_cache()


def _scale_run(torch, native, card, perf, results, launch_of, trace,
               out_dir):
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import tiered as ti
    from fabstir_vectordb_tpu_torch.index.hybrid import (
        HybridConfig, HybridIndex, SearchConfig)
    from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig
    from fabstir_vectordb_tpu_torch.ops import kmeans as km
    from fabstir_vectordb_tpu_torch.utils import synth

    n, d, k = SCALE_ROWS, 384, 10
    stage = {}
    src = synth.SyntheticCorpusSource(seed=0, dim=d, n_centers=4096,
                                      scale=0.35, block_rows=SCALE_BLOCK_ROWS)
    h = HybridIndex(d, HybridConfig(
        ivf=IVFConfig(n_clusters=256, n_probe=16, train_size=10_000, seed=0),
        auto_migrate=False), device=None)
    store, dev = h.store, h.store.torch_device
    cfg = SearchConfig(auto_migrate=False)

    # ---- the main path, counted from 0
    native.reset_launches()
    t = time.perf_counter()
    ids = [f"v{i}" for i in range(n)]
    stage["id_strings"] = time.perf_counter() - t
    t_reg = time.perf_counter()
    store.register_rows(ids, timestamps=NOW - 30 * DAY)
    stage["register_rows"] = time.perf_counter() - t_reg
    stage["register"] = time.perf_counter() - t  # both, as before
    del ids
    t = time.perf_counter()
    cents, pending = None, []
    for lo in range(0, n, src.block_rows):
        hi = min(lo + src.block_rows, n)
        blk = src.device_block(lo // src.block_rows)[: hi - lo]  # K17, f32
        store.fill_rows(lo, blk.cpu().numpy())  # the host copy, once
        if cents is None:
            h.initialize(store.data[:10_000])
            cents = torch.from_numpy(h.ivf.centroids).to(dev)
        # K6 on the f32 block (bench.py assigns a bf16 copy against bf16
        # centroids): it shapes only the IVF lists, which this regime reads
        # as a member mask
        pending.append((lo, hi, km.assign_clusters(blk, cents)[0]))
        del blk
    h.ivf._ensure_capacity()
    for lo, hi, a in pending:
        h.ivf.assignments[lo:hi] = a.cpu().numpy()
    del pending
    store.bump_version()
    h.ivf._version += 1
    torch.cuda.synchronize()
    stage["generate_fill_assign"] = time.perf_counter() - t
    if not (h.ivf.assignments[:n] >= 0).all():
        fail("scale: a row has no IVF list")
    t = time.perf_counter()
    chk = np.random.default_rng(909).integers(0, n, 8)
    if not src.spot_check(store.data, chk):
        fail("scale: the spot check refused the source's own rows")
    store.attach_device_source(src)
    stage["spot_check"] = time.perf_counter() - t
    print(f"scale: {n} x {d} registered in {stage['register']:.3f} s "
          f"(id strings {stage['id_strings']:.3f} s, register_rows "
          f"{stage['register_rows']:.3f} s), "
          f"generated (K17) + filled + assigned (K6) in "
          f"{stage['generate_fill_assign']:.3f} s, spot check of 8 rows "
          f"{stage['spot_check']:.3f} s; capacity {store.capacity}; "
          f"{memory_line(torch)} ({card})", flush=True)

    rng10 = np.random.default_rng(707)  # bench.py's query stream
    seeds = rng10.integers(0, n, 100)
    queries = store.data[seeds] + 0.1 * rng10.standard_normal(
        (100, d)).astype(np.float32)

    clock = StageClock(torch)
    clock.wrap(src, "mirror_bf16", "rerank mirror (K17)")
    clock.wrap(h.fused, "_build_proj_mirror", "projection pass (K14)")
    clock.wrap(h.fused, "_calibrate_oversample", "calibration")
    clock.wrap(fu, "pca_basis", "PCA fit (host)")
    clock.wrap(store, "host_sq", "host row norms")
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        h.search_rows(queries[0], k, config=cfg, now=NOW)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
    finally:
        clock.undo()
    build = dict(clock.s)
    info = h.fused.serving_info()
    proj = h.fused._proj
    if info["regime"] != "reduced-rank" or info["pca_rerank"] != "device" \
            or info["pca_rank"] != 192 or info["pca_oversample"] != 96:
        fail(f"scale: serving_info {info}")
    print(f"scale: first search {first_s:.3f} s: " + ", ".join(
        f"{name} {v:.3f} s" for name, v in build.items())
        + f"; {proj['n_rows']} mirror rows; {memory_line(torch)} ({card})",
        flush=True)

    lat = []
    for q in queries:
        t = time.perf_counter()
        h.search_rows(q, k, config=cfg, now=NOW)
        lat.append((time.perf_counter() - t) * 1e3)
    p50 = float(np.percentile(lat, 50))
    bq = np.random.default_rng(0).standard_normal((128, d)).astype(np.float32)
    h.search_rows(bq, k, config=cfg, now=NOW)
    t = time.perf_counter()
    for _ in range(5):
        h.search_rows(bq, k, config=cfg, now=NOW)
    qps = 5 * 128 / (time.perf_counter() - t)

    sample = queries[:32]
    members = store.active_mask()[:n] & (h.hnsw.member_mask()[:n]
                                         | h.ivf.member_mask()[:n])
    t = time.perf_counter()
    oracle = ti.TieredFlatSearcher(store.data[:n], members)
    _, exact = oracle.search(sample, k)
    oracle_s = time.perf_counter() - t
    _, got = h.search_rows(sample, k, config=cfg, now=NOW)
    rec = recall(got, exact)
    torch.cuda.synchronize()
    counts = dict(native.launches)
    note_shapes("scale-10M", native)
    path = {"synth_rows": "K17", "assign_clusters": "K6",
            "project_rows": "K14 projection",
            "project_queries": "K14 queries", "stage1_select": "K14 select",
            "rerank_f32": "K2", "l2_topk": "the tile step's K1",
            "merge_topk": "the tile step's merge"}
    for name, what in path.items():
        if counts[name] <= 0:
            fail(f"scale path: {what} ({name}) was launched no time")
    print(f"scale: search p50 {p50:.3f} ms over 100 single k=10 searches, "
          f"batched {qps:.1f} QPS over 5 x 128; recall@10 {rec:.4f} over 32 "
          f"queries against the streamed exact oracle ({oracle.n_tiles} tiles "
          f"of {oracle.tile_rows} rows, {oracle_s:.3f} s); {memory_line(torch)}"
          f" ({card})", flush=True)
    print(f"scale: launches { {name: counts[name] for name in path} }; "
          f"stage 1 by route { {c: counts[c] for c in S1_ROUTES} }",
          flush=True)
    if rec < 0.95:
        fail(f"scale: recall@10 {rec} < 0.95")
    if store._mirror is not None or h.fused._dev is not None:
        fail("scale: a full-dim f32 mirror is held")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    own = sum(x.numel() * x.element_size() for x in (
        proj["xp"], proj["xp_sq"], proj["rerank_x"], h.fused._members_dev))
    if held - own >= n * d * 4:
        fail(f"scale: {held - own} bytes held beside the regime's {own}")
    if trace:
        for name, fn in (
                ("scale_single", lambda: [h.search_rows(q, k, config=cfg,
                                                        now=NOW)
                                          for q in queries[:32]]),
                ("scale_batched", lambda: [h.search_rows(bq, k, config=cfg,
                                                         now=NOW)
                                           for _ in range(2)])):
            wall, dev_ms = device_trace(torch, name, fn, out_dir)
            print(f"trace {name}: wall {wall:.3f} ms, device {dev_ms:.3f} ms, "
                  f"busy share {dev_ms / wall:.3f} ({card})", flush=True)
    # ---- kernels against their plain versions at this tier's shapes
    scale_kernel_checks(torch, src, h, proj, sample, bq, oracle, members,
                        counts, results, launch_of)

    # ---- the source-built mirror against one uploaded from the host rows
    mirror_src = proj["rerank_x"]
    store.attach_device_source(None)
    h.fused._release_proj()
    del proj
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, got_up = h.search_rows(sample, k, config=cfg, now=NOW)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    if not np.array_equal(got_up, got):
        fail("scale: the uploaded mirror answers otherwise than the "
             "source-built one")
    mirror_up = h.fused._proj["rerank_x"]
    # rows past the count: synthetic in one, zeros in the other, masked out
    mirror_diff = int((mirror_up[:n] != mirror_src[:n]).sum())
    del mirror_src, mirror_up
    print(f"scale: the host-uploaded mirror's state built in {upload_s:.3f} s "
          f"(from the source: {first_s:.3f} s); the same rows for the 32 "
          f"queries; {mirror_diff} of {n * d} mirror elements differ "
          f"({card})", flush=True)

    # ---- deletes keep the source, a fill detaches it
    if not src.spot_check(store.data, chk):
        fail("scale: the spot check refused the rows")
    store.attach_device_source(src)
    rng = np.random.default_rng(21)
    top = [int(v) for row in got for v in row[:3] if v >= 0]
    dead = list(dict.fromkeys(
        top + rng.choice(n, 1000, replace=False).tolist()))[:1000]
    if h.batch_delete([f"v{r}" for r in dead]) != 1000:
        fail("scale: batch_delete")
    if store.device_source is not src:
        fail("scale: a soft delete detached the source")
    t = time.perf_counter()
    _, after = h.search_rows(sample, k, config=cfg, now=NOW)
    del_s = time.perf_counter() - t
    if np.isin(after, dead).any():
        fail("scale: a deleted row was returned")
    store.fill_rows(0, store.data[:1].copy())
    if store.device_source is not None:
        fail("scale: fill_rows kept the source attached")
    if not src.spot_check(store.data, chk):
        fail("scale: the spot check refused the rows")
    store.attach_device_source(src)

    # ---- one rebuild with rank and oversample on auto
    os.environ.pop("FVDB_PCA_RANK")
    os.environ.pop("FVDB_PCA_OVERSAMPLE")
    h.fused._release_proj()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, auto_rows = h.search_rows(sample, k, config=cfg, now=NOW)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t
    ainfo = h.fused.serving_info()
    _, exact2 = oracle.search(sample, k, extra_mask=store.active_mask()[:n])
    auto_rec = recall(auto_rows, exact2)
    print(f"scale: 1,000 deletes kept the source, rebuilt in {del_s:.3f} s, "
          f"none returned; fill_rows detached it. Auto rebuild in "
          f"{auto_s:.3f} s: rank {ainfo['pca_rank']} (doubled: "
          f"{ainfo['pca_rank_doubled']}), oversample "
          f"{ainfo['pca_oversample']}, calibrated recall "
          f"{ainfo['pca_calibrated_recall']}, stage 2 {ainfo['pca_rerank']}; "
          f"recall@10 {auto_rec:.4f}; {memory_line(torch)} ({card})",
          flush=True)
    perf.update(
        scale_rows=n, scale_register_s=stage["register"],
        scale_id_strings_s=stage["id_strings"],
        scale_register_rows_s=stage["register_rows"],
        scale_generate_fill_assign_s=stage["generate_fill_assign"],
        scale_first_search_s=first_s, scale_build_stages_s=build,
        scale_search_p50_ms=p50, scale_batched_qps=qps,
        scale_recall_at_10=rec, scale_oracle_s=oracle_s,
        scale_upload_build_s=upload_s, scale_mirror_elements_differing=mirror_diff,
        scale_delete_rebuild_s=del_s, scale_auto_build_s=auto_s,
        scale_auto_rank=ainfo["pca_rank"],
        scale_auto_oversample=ainfo["pca_oversample"],
        scale_auto_calibrated_recall=ainfo["pca_calibrated_recall"],
        scale_auto_recall_at_10=auto_rec,
        scale_device_peak_bytes=torch.cuda.max_memory_allocated())


def scale_kernel_checks(torch, src, h, proj, sample, bq, oracle, members,
                        counts, results, launch_of):
    """K17, K6, the tile step, K14 and K2 against their plain versions at
    the 10M tier's shapes, on its own state."""
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import tiered as ti
    from fabstir_vectordb_tpu_torch.ops import kmeans as km
    from fabstir_vectordb_tpu_torch.utils import limits, native, synth
    from fabstir_vectordb_tpu_torch.utils.padding import bucket

    store = h.store
    n, d, k = SCALE_ROWS, src.dim, 10
    dev = store.torch_device
    br = src.block_rows
    n_el = br * d
    # K17 over block 0, the plain version in slices of 65,536 rows; then 64
    # sampled rows of every other block
    kz, ka = src.block_keys(0)
    cents = src.centers()
    f32_k, a_k = src.rows(0, range(0, br))
    bf_k = src.rows(0, range(0, br), torch.bfloat16)[0]
    err, ulp_max, ulp_n = 0.0, 0, 0
    slices = [(lo, min(lo + 65_536, br)) for lo in range(0, br, 65_536)]
    for lo, hi in slices:
        idx = torch.arange(lo, hi, device=dev)
        vp, ap = synth.synth_rows_plain(kz, ka, idx, d, cents, src.scale)
        if not torch.equal(ap, a_k[lo:hi]):
            fail("synth_rows: an assignment differs from the plain version")
        err = max(err, float((vp - f32_k[lo:hi]).abs().max()))
        u = bf16_ulps(torch, bf_k[lo:hi], vp.to(torch.bfloat16))
        ulp_max, ulp_n = max(ulp_max, int(u.max())), ulp_n + int((u > 0).sum())
    rng = np.random.default_rng(31)
    for b in range(1, -(-n // br)):
        offs = np.sort(rng.integers(0, min(br, n - b * br), 64))
        vk, ak = src.rows(b, offs)
        bk = src.rows(b, offs, torch.bfloat16)[0]
        kzb, kab = src.block_keys(b)
        vp, ap = synth.synth_rows_plain(
            kzb, kab, torch.from_numpy(offs).to(dev), d, cents, src.scale)
        if not torch.equal(ak, ap):
            fail(f"synth_rows: block {b}'s sampled assignments differ")
        err = max(err, float((vk - vp).abs().max()))
        u = bf16_ulps(torch, bk, vp.to(torch.bfloat16))
        ulp_max, ulp_n = max(ulp_max, int(u.max())), ulp_n + int((u > 0).sum())
    tol = 1e-6
    share = ulp_n / (n_el + 64 * d * (-(-n // br) - 1))
    if err > tol or ulp_max > 1 or share > 0.005:
        fail(f"synth_rows: f32 max_abs_err {err} (tol {tol}), bf16 {ulp_max} "
             f"ulps at most, {share} of elements off")
    del f32_k, a_k, vp, ap
    out = torch.empty((br, d), dtype=torch.bfloat16, device=dev)
    rows0 = range(0, br)

    def plain_block():
        for lo, hi in slices:
            synth.synth_rows_plain(kz, ka, torch.arange(lo, hi, device=dev),
                                   d, cents, src.scale, torch.bfloat16)

    int_ops = 80.0 * n_el + 160.0 * br  # threefry + uniform; 2 draws a row
    t_b, t_o = (n_el * 2 + br * 4 + 4096 * d * 4) / HBM_BYTES_PER_S, \
        int_ops / INT32_OPS
    results["synth_rows[bf16 block]"] = dict(
        shape=f"rows={br} D={d} centers=4096 -> bf16", max_abs_err=err,
        tol=tol, bf16_ulps_max=ulp_max, bf16_share_one_ulp=share,
        ms=cuda_ms(torch, lambda: synth.synth_rows(
            kz, ka, rows0, d, cents, src.scale, torch.bfloat16, out=out)),
        plain_ms=cuda_ms(torch, plain_block, iters=1, warmup=1),
        library_ms=None, bound_ms=max(t_b, t_o) * 1e3,
        bound_by="bytes" if t_b >= t_o else "operations (int32)")
    launch_of["synth_rows[bf16 block]"] = counts["synth_rows"]
    del out, bf_k

    # K6: the assignment of block 0 against the 256 trained centroids
    blk = src.device_block(0)
    cents_ivf = torch.from_numpy(h.ivf.centroids).to(dev)
    ak, dk = km.assign_clusters(blk, cents_ivf)
    ap, dp = km.assign_clusters_plain(blk, cents_ivf)
    agree = float((ak == ap).float().mean())
    if agree < 0.999:
        fail(f"assign_clusters: {agree} of rows agree with the plain version")
    c = cents_ivf.shape[0]
    nbytes, ops = lloyd_work(br, d, c, 1)
    bms, by = bound(nbytes + br * 8, ops)
    results["assign_clusters[10M tier block]"] = dict(
        shape=f"N={br} C={c} D={d}", max_abs_err=float(
            (dk - dp)[ak == ap].abs().max()), agree=agree,
        ms=cuda_ms(torch, lambda: km.assign_clusters(blk, cents_ivf)),
        plain_ms=cuda_ms(torch, lambda: km.assign_clusters_plain(
            blk, cents_ivf), iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by)
    launch_of["assign_clusters[10M tier block]"] = counts["assign_clusters"]
    del blk, ak, ap, dk, dp

    # the tile step on the oracle's first tile (32 queries, k = 10)
    tr = oracle.tile_rows
    xt = torch.from_numpy(store.data[:tr]).to(dev)
    mt = torch.from_numpy(members[:tr]).to(dev)
    qt = torch.from_numpy(sample).to(dev)
    v0 = torch.full((32, k), float("inf"), device=dev)
    r0 = torch.full((32, k), -1, dtype=torch.int32, device=dev)
    vk, rk = ti.tile_step(xt, mt, qt, tr, v0, r0, k)
    vp, rp = ti.tile_step_plain(xt, mt, qt, tr, v0, r0, k)
    tol = 2e-5 * float((xt[:65_536] ** 2).sum(1).max()
                       + (qt * qt).sum(1).max())
    err, differ = topk_check("tile_step", vk, rk, vp, rp, tol)
    n_in = int(mt.sum())
    bms, by = route_bound(tr * (d * 4 + 1) + 32 * d * 4 + 3 * 32 * k * 8,
                          2.0 * 32 * n_in * d + 2.0 * tr * d,
                          fu.tile_route(xt.dtype, False, d))
    results["tile_step"] = dict(
        shape=f"B=32 tile={tr} D={d} k={k} (norms in the kernel, row base)",
        max_abs_err=err, tol=tol, rows_differing_at_ties=differ,
        ms=cuda_ms(torch, lambda: ti.tile_step(xt, mt, qt, tr, v0, r0, k)),
        plain_ms=cuda_ms(torch, lambda: ti.tile_step_plain(
            xt, mt, qt, tr, v0, r0, k), iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by)
    launch_of["tile_step"] = min(counts["l2_topk"], counts["merge_topk"])
    del xt, mt

    # K14 and K2 on the served state (10,485,760 mirror rows)
    xp, xp_sq, rx = proj["xp"], proj["xp_sq"], proj["rerank_x"]
    mu, pm = proj["mu"], proj["p"]
    n_rows, r = xp.shape
    mem = h.fused._members_state(n_rows)
    n_in = int(mem.sum())
    ov = min(bucket(16 * 96), n_rows)
    q128 = torch.from_numpy(bq).to(dev)
    qp = fu.project_queries(q128, mu, pm)
    budget = limits.stage1_transient_bytes()  # as the dispatch passes it
    for tag, b in (("B=1", 1), ("B=32", 32), ("B=128", 128)):
        qb = qp[:b].contiguous()
        native.reset_launches()
        vk, rk = fu.stage1_select(xp, xp_sq, mem, qb, ov, budget)
        one = native.launches["stage1_select"]
        if tag == "B=128":
            pool = rk
            if one != 1:
                fail(f"stage1_select[10M B=128]: {one} launches, not one")
        # the plain version in slices of 32 queries ([32, N] f32 at a time)
        tol = 2e-5 * float(xp_sq.max() + (qb * qb).sum(1).max())
        err, differ = 0.0, 0
        for lo in range(0, b, 32):
            vp, rp = fu.stage1_select_plain(xp, xp_sq, mem,
                                            qb[lo:lo + 32], ov)
            e, dd = topk_check(f"stage1_select[10M {tag}]", vk[lo:lo + 32],
                               rk[lo:lo + 32], vp, rp, tol)
            err, differ = max(err, e), differ + dd
            del vp, rp
        bms, by = bound(n_rows * (r * 2 + 4 + 1) + b * r * 4 + b * ov * 8,
                        2.0 * b * n_in * r, BF16_FLOPS)
        key = f"stage1_select[10M {tag}]"
        results[key] = dict(
            shape=f"B={b} N={n_rows} r={r} ov_k={ov}", max_abs_err=err,
            tol=tol, rows_differing_at_ties=differ,
            ms=cuda_ms(torch, lambda: fu.stage1_select(xp, xp_sq, mem, qb,
                                                       ov, budget), iters=3),
            # the plain version over all b queries, in the slices of 32
            # that it was checked in
            plain_ms=cuda_ms(torch, lambda: [
                fu.stage1_select_plain(xp, xp_sq, mem, qb[lo:lo + 32], ov)
                for lo in range(0, b, 32)], iters=1, warmup=1),
            library_ms=None, bound_ms=bms,
            bound_by=f"{by} (bf16 tensor-core rate)",
            tile_pass=fu.tile_route(torch.bfloat16, True, r),
            launches_one_call=one,
            **{f"{c}_launches": counts[c] for c in S1_ROUTES[1:]})
        launch_of[key] = counts["stage1_select"]
    m = min(64, ov)
    k2_entry(torch, fu, results, "rerank_f32[10M]", rx, q128, pool, m)
    k2_entry(torch, fu, results, "rerank_f32[10M B=1]", rx,
             q128[:1].contiguous(), pool[:1].contiguous(), m)
    for key in ("rerank_f32[10M]", "rerank_f32[10M B=1]"):
        launch_of[key] = counts["rerank_f32"]
    blk_n = min(524_288, n_rows)  # a block of the device-mode projection
    blk = rx[:blk_n]
    out_k = torch.empty((blk_n, r), dtype=torch.bfloat16, device=dev)
    sq_k = torch.empty(blk_n, device=dev)
    out_p, sq_p = torch.empty_like(out_k), torch.empty_like(sq_k)
    fu.project_rows(blk, mu, pm, out_k, sq_k, 0)
    fu.project_rows_plain(blk, mu, pm, out_p, sq_p, 0)
    yk, yp = out_k.float(), out_p.float()
    same = float((yk == yp).float().mean())
    if same < 0.999 or not torch.equal(out_k, xp[:blk_n]):
        fail(f"project_rows[10M]: {same} of elements equal, or the served "
             f"mirror's first block differs")
    centered = blk.float() - mu
    bms, by = project_bound(blk_n, d, r)
    results["project_rows[10M]"] = dict(
        shape=f"n={blk_n} D={d} r={r} (the K17 mirror's rows)",
        max_abs_err=float((yk - yp).abs().max()), equal_share=same,
        ms=cuda_ms(torch, lambda: fu.project_rows(blk, mu, pm, out_k, sq_k,
                                                  0)),
        plain_ms=cuda_ms(torch, lambda: fu.project_rows_plain(
            blk, mu, pm, out_p, sq_p, 0), iters=2, warmup=1),
        library_ms=cuda_ms(torch, lambda: torch.matmul(centered, pm)),
        bound_ms=bms, bound_by=f"{by} (3 bf16 products, tensor-core rate)")
    launch_of["project_rows[10M]"] = counts["project_rows"]
    del centered, out_k, out_p, yk, yp
    for name in ("synth_rows[bf16 block]", "assign_clusters[10M tier block]",
                 "tile_step", "stage1_select[10M B=1]",
                 "stage1_select[10M B=32]", "stage1_select[10M B=128]",
                 "rerank_f32[10M]", "rerank_f32[10M B=1]",
                 "project_rows[10M]"):
        print_kernel(name, results[name], launch_of[name])


def pp_divergence(km, seed, x, mask, rk, rp, n_sub=1):
    """The first k-means++ pick where the kernel's rows rk [n_sub, C] and
    the plain version's rp differ, over the subspaces, and the largest
    relative gap between the two rows' keys E / d2 there ((None, 0.0) if
    none). The keys must tie within 1e-6, under the plain version's d2 and
    the draw that ``seed`` keys."""
    from tests.test_torch_kmeans_checks import pp_key_gaps

    gaps = pp_key_gaps(seed, x, mask, rk, rp, n_sub)
    if not gaps:
        return None, 0.0
    for m, i, gap in gaps:
        if not gap <= 1e-6:
            fail(f"k-means++: subspace {m} pick {i} differs off a tie (gap "
                 f"{gap})")
    return min(i for _, i, _ in gaps), max(g for _, _, g in gaps)


def codes_check(torch, tag, x, cents, got, want, rel=1e-6):
    """PQ codes equal, or the two codes' distances to the row's subvector
    tie within rel of the norm expansion's terms. Returns the count of
    codes that differ and the largest gap between two such distances."""
    ds = cents.shape[2]
    n_idx, m_idx = torch.nonzero(got != want, as_tuple=True)
    if n_idx.numel() > 1000:
        fail(f"{tag}: {n_idx.numel()} codes differ")
    gap = 0.0
    for n, j in zip(n_idx.tolist(), m_idx.tolist()):
        v = x[n, j * ds:(j + 1) * ds].double()
        a = cents[j, int(got[n, j])].double()
        b = cents[j, int(want[n, j])].double()
        da, db = ((v - a) ** 2).sum(), ((v - b) ** 2).sum()
        scale = (v * v).sum() + max((a * a).sum(), (b * b).sum())
        if abs(float(da - db)) > rel * float(scale):
            fail(f"{tag}: row {n} subspace {j}: code {int(got[n, j])} "
                 f"against {int(want[n, j])} off a tie")
        gap = max(gap, abs(float(da - db)))
    return int(n_idx.numel()), gap


def pq_train_from_state(torch, km, qz, gen, x, m: int, k: int,
                        plain: bool, init=None):
    """pq_train's steps from ``gen``'s state, through the kernels or their
    plain versions: (centroids [M, K, Ds], each subspace's Lloyd
    iterations, the seeding's seconds, Lloyd's seconds). ``init``: the
    seeds [M, K, Ds] already drawn from that state (no seeding then)."""
    n, d = x.shape
    ds = d // m
    mask = torch.ones(n, dtype=torch.bool, device=x.device)
    block = km.lloyd_block_plain if plain else km.lloyd_block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if init is None:
        init = qz.pq_seeds(gen, x, m, k, plain)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = [km._lloyd_until(x[:, j * ds:(j + 1) * ds].contiguous(), mask,
                           init[j].contiguous(), 25, 1e-4, block)
           for j in range(m)]
    torch.cuda.synchronize()
    return (torch.stack([r.centroids for r in res]),
            [r.iterations for r in res], t1 - t0, time.perf_counter() - t1)


def pq_distortion(torch, qz, cents, x):
    """Mean squared error of x's PQ reconstruction (the plain versions)."""
    dec = qz.pq_decode_plain(cents, qz.pq_encode_plain(cents, x))
    return float(((dec - x) ** 2).sum(1).mean())


def pp_work(n: int, d: int, c: int):
    """k-means++ over n x d rows (every subspace of them), as (bytes, f32
    ops): the c - 1 updates that follow all but the last pick read the
    rows once each (2 n d ops), each pick reads the mask."""
    return c * n + (c - 1) * n * d * 4, 2.0 * (c - 1) * n * d


def lloyd_work(n: int, d: int, c: int, iterations: int):
    """Lloyd iterations over n x d rows and c centroids, as (bytes, f32
    ops): the rows and centroids read and 2 n c d ops each; on K6's
    tensor-core route (ops.kmeans.lloyd_route) three TF32 products of
    them, given as the f32 ops that take as long at bound()'s f32 rate."""
    from fabstir_vectordb_tpu_torch.ops.kmeans import lloyd_route

    ops = iterations * 2.0 * n * c * d
    if lloyd_route(n, c, d) == "tf32x3":
        ops *= 3 * F32_FLOPS / TF32_FLOPS
    return iterations * (n * d * 4 + 2 * c * d * 4), ops


def launch_delta(native, before: dict) -> dict:
    """The launches since ``before`` (a copy of the counters)."""
    return {k: v - before.get(k, 0) for k, v in native.launches.items()
            if v != before.get(k, 0)}


def quant_phase(torch, native, card: str, perf: dict, results: dict,
                launch_of: dict, x_np=None):
    """k-means and quantization (K7 rest, K16) on bench.py's 1M tier rows
    (1,000,000 x 384, 1,024 centers, 0.35 noise; ``x_np``, else made
    here), as a user of the ops entry points runs them: kmeans_train on
    the first 65,536 rows (C = 256); at M = 8 and M = 48 (K = 256) a PQ
    codebook trained on those rows, all 1M rows encoded, tables for 128
    queries drawn as bench.py draws them, the ADC scan [128, 1M] and its
    top-10 by chunked_topk; u8 codes of all 1M rows and their decode. The
    counters must show every kernel of the path; then the hard checks,
    the recall against K1's exact top-10 (a report), and each kernel
    against its plain version at these shapes."""
    import gc

    from fabstir_vectordb_tpu_torch.ops import kmeans as km
    from fabstir_vectordb_tpu_torch.ops import quantization as qz
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils.device import resolve_device
    from tests import test_torch_kmeans_checks as kchk

    dev = resolve_device(None)
    if x_np is None:
        t = time.perf_counter()
        x_np, _ = bench_corpus(PRUNED_ROWS, 384, seed=0)
        print(f"quant: corpus {x_np.shape[0]} x {x_np.shape[1]} made in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    n, d = x_np.shape
    nt, b, kc = QUANT_TRAIN_ROWS, QUANT_QUERIES, 256
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x = torch.from_numpy(x_np).to(dev)
    train = x[:nt]
    tmask = torch.ones(nt, dtype=torch.bool, device=dev)
    rng = np.random.default_rng(11)  # bench.py's draw: rows + 0.1 noise
    seeds = rng.integers(0, n, b)
    q = torch.from_numpy(x_np[seeds] + 0.1 * rng.standard_normal(
        (b, d)).astype(np.float32)).to(dev)
    sample = torch.from_numpy(np.random.default_rng(12).choice(
        n, QUANT_SAMPLE, replace=False)).to(dev)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def step(fn):
        """fn() timed, and the launches it made."""
        before = dict(native.launches)
        out, sec = timed(fn)
        return out, sec, launch_delta(native, before)

    # the path, counters from 0
    native.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(0)
    train_state = gen.get_state()
    res, km_s, km_l = step(lambda: km.kmeans_train(gen, train, tmask, kc))
    pq = {}
    for m in (8, 48):
        st = gen.get_state()
        cb, train_s, train_l = step(lambda: qz.pq_train(gen, train, m, kc,
                                                        25))
        codes, enc_s, enc_l = step(lambda: qz.pq_encode(cb.centroids, x))
        table, tab_s, tab_l = step(lambda: qz.pq_adc_table(cb.centroids, q))
        dist, scan_s, scan_l = step(lambda: qz.pq_adc_distances(table, codes))
        (_, rows), sel_s, _ = step(tp.chunked_topk(
            lambda s: (dist[:, s:s + ADC_CHUNK].contiguous(), None), n,
            ADC_CHUNK, 10, b, device=dev))
        dec, dec_s, dec_l = step(lambda: qz.pq_decode(cb.centroids, codes))
        re = qz.pq_encode(cb.centroids, dec)  # the decoded rows' codes
        re_differ, _ = codes_check(torch, f"pq M={m} re-encode", dec,
                                   cb.centroids, re, codes)
        pq[m] = dict(cb=cb, codes=codes, table=table, rows=rows, state=st,
                     train_s=train_s, enc_s=enc_s, tab_s=tab_s,
                     scan_s=scan_s, sel_s=sel_s, dec_s=dec_s,
                     re_differ=re_differ, train_l=train_l, enc_l=enc_l,
                     tab_l=tab_l, scan_l=scan_l, dec_l=dec_l,
                     dec_sample=dec[sample].contiguous(),
                     adc_sample=dist[:, sample].contiguous())
        del dist, dec, re
    (u8c, u8m, u8s), u8q_s, u8q_l = step(lambda: qz.quantize_u8(x))
    y, u8d_s, u8d_l = step(lambda: qz.dequantize_u8(u8c, u8m, u8s))
    counts = dict(native.launches)
    note_shapes("quant-1m", native)
    path = ("kmeans_pp", "lloyd_block", "quantize_u8",
            "dequantize_u8", "pq_encode", "pq_decode", "pq_adc_table",
            "pq_adc_distances", "chunk_step")
    for name in path:
        if counts[name] <= 0:
            fail(f"quant: {name} was launched no time on the path")
    quant_peak = (torch.cuda.max_memory_allocated() - base) / 1e9

    # hard checks and the reports
    if not np.isfinite(res.final_error) or res.centroids.shape != (kc, d):
        fail(f"kmeans_train: error {res.final_error}, centroids "
             f"{tuple(res.centroids.shape)}")
    par = km.kmeans_train_stepped(0, train, tmask, kc)
    _, exact = tp.l2_topk(x, None, None, q, 10)
    q64 = q.double()
    for m, r in pq.items():
        dec_s = r["dec_sample"].double()
        ex = ((q64 * q64).sum(1)[:, None] - 2.0 * q64 @ dec_s.T
              + (dec_s * dec_s).sum(1)[None, :])
        rel = float(((r["adc_sample"].double() - ex).abs()
                     / ex.clamp_min(1.0)).max())
        if rel > 1e-4:
            fail(f"pq M={m}: ADC off the decoded rows' distances by {rel}")
        r["recall"] = recall(r["rows"].cpu().numpy(), exact.cpu().numpy())
        r["adc_rel"] = rel
    # half a step, plus f32 rounding of the decode (code * scale + min),
    # which scales with the row's min as well as with the element
    err_u8 = (y - x).abs() - (u8s[:, None] / 2
                              + 1e-6 * (x.abs() + u8m.abs()[:, None]))
    if float(err_u8.max()) > 0:
        fail(f"u8: an element off its row's value by more than half a step "
             f"({float(err_u8.max())} over)")
    del y, err_u8
    print(f"quant: kmeans_train N={nt} C={kc}: {km_s:.3f} s, "
          f"{res.iterations} iterations, converged {res.converged}, error "
          f"{res.final_error:.4f}; kmeans|| (kmeans_train_stepped) "
          f"{par.iterations} iterations, error {par.final_error:.4f} "
          f"({card})", flush=True)
    for m, r in pq.items():
        print(f"quant: PQ M={m} K={kc} (first calls): train "
              f"{r['train_s']:.3f} s, encode {n} rows {r['enc_s']:.4f} s, "
              f"tables {r['tab_s'] * 1e3:.3f} "
              f"ms, ADC scan [{b}, {n}] {r['scan_s'] * 1e3:.3f} ms, top-10 "
              f"{r['sel_s'] * 1e3:.3f} ms, decode {r['dec_s'] * 1e3:.3f} ms; "
              f"recall@10 against K1's exact top-10 {r['recall']:.4f}; ADC "
              f"against the decoded rows {r['adc_rel']:.2e} relative; "
              f"re-encoded codes differing at ties {r['re_differ']} "
              f"({card})", flush=True)
    print(f"quant: u8 quantize {u8q_s * 1e3:.3f} ms, dequantize "
          f"{u8d_s * 1e3:.3f} ms over {n} x {d}; every element within half "
          f"a step; launches {[counts[k] for k in path]}; phase device "
          f"peak {quant_peak:.3f} GB above the {base / 1e9:.3f} GB held "
          f"({card})", flush=True)
    perf.update(kmeans_train_s=km_s, kmeans_train_error=res.final_error,
                kmeans_train_iterations=res.iterations,
                kmeans_par_error=par.final_error,
                u8_quantize_s=u8q_s, u8_dequantize_s=u8d_s,
                quant_device_peak_gb=quant_peak)
    for m, r in pq.items():
        perf.update({f"pq_recall_at_10_m{m}": r["recall"],
                     f"pq_train_s_m{m}": r["train_s"]})

    # each kernel against its plain version at these shapes
    names = []

    def entry(name, launches, **r):
        results[name] = r
        launch_of[name] = launches
        names.append(name)

    def own(launches: dict, *kernels) -> int:
        """An entry's launches on the path: those of its kernels in its
        own call (at least one)."""
        got = sum(launches.get(k, 0) for k in kernels)
        if got < 1:
            fail(f"quant: {kernels} launched no time in their call")
        return got

    def pp_entry(name, launches, m):
        """K7's k-means++ kernel over the training rows in m subspaces
        (one launch) against its plain version from the path's seed: pick
        for pick up to key ties, the card's Philox routine bit for bit
        (the fused kernel's own draws are covered by its picks). Returns the
        plain version's rows and seconds, which the plain trainings below
        start from."""
        g = torch.Generator(device=dev)
        g.set_state(train_state if m == 1 else pq[m]["state"])
        seed = km.pp_seed(g)
        rows, sec = {}, {}
        for plain in (False, True):
            rows[plain], sec[plain] = timed(lambda: km.kmeans_pp_rows(
                seed, train, tmask, kc, m, plain))
        tie_at, key_gap = pp_divergence(km, seed, train, tmask, rows[False],
                                        rows[True], m)
        # the card's Philox routine, which the kernel draws through
        for sub, st in ((0, 0), (m - 1, 1), (m // 2, kc - 1)):
            if not torch.equal(
                    kchk.pp_uniforms_card(seed, sub, st, nt, dev),
                    km.pp_uniforms(seed, [sub], st, nt, dev)[0]):
                fail(f"{name}: the card's uniforms at subspace {sub} "
                     f"step {st} differ from the plain version's")
        bms, by = bound(*pp_work(nt, d, kc))
        entry(name, own(launches, "kmeans_pp"),
              shape=f"M={m} N={nt} Ds={d // m} C={kc}", max_abs_err=key_gap,
              first_tie_pick=tie_at,
              ms=cuda_ms(torch, lambda: km.kmeans_pp_rows(
                  seed, train, tmask, kc, m), iters=3, warmup=1),
              plain_ms=sec[True] * 1e3, library_ms=None, bound_ms=bms,
              bound_by=by)
        return rows[False], rows[True], sec[True]

    # k-means++ (K7's kernel, one launch) and kmeans_train (K6)
    ppk, ppp, pp_plain_s = pp_entry("kmeans_pp", km_l, 1)
    bms, by = bound(*pp_work(nt, d, kc))
    entry("kmeans_pp_init", own(km_l, "kmeans_pp"),
          shape=f"N={nt} D={d} C={kc}",
          max_abs_err=results["kmeans_pp"]["max_abs_err"],
          first_tie_pick=results["kmeans_pp"]["first_tie_pick"],
          ms=cuda_ms(torch, lambda: km.kmeans_pp_init(gen, train, tmask, kc),
                     iters=3, warmup=1),
          plain_ms=results["kmeans_pp"]["plain_ms"], library_ms=None,
          bound_ms=bms, bound_by=by)
    # Lloyd from the same seeds through K6 and its plain version: the same
    # stop, the same error within 1%, the same centroids. K6's run is held
    # step by step on its own steps: each within ctol of the plain step
    # from the same centroids, a row that it or the plain run sends apart
    # only at a float64 tie within the tensor cores' error (kchk.TIE; two
    # roundings send such a row either way, and the runs part there), the
    # two runs' centroids within ctol until they part, and at the end if
    # they never do
    init = train[ppk[0].long()]
    logs = [], []
    rk = km._lloyd_until(train, tmask, init, 25, 1e-4,
                         kchk.recording(km.lloyd_block, logs[0]))
    rs = km._lloyd_until(train, tmask, init, 25, 1e-4,
                         kchk.recording(km.lloyd_block_plain, logs[1]))
    cerr = float((rk.centroids - rs.centroids).abs().max())
    ctol = 1e-5 * float(train.abs().max())
    held = kchk.lloyd_check(train, tmask, init, *logs,
                            min(rk.iterations, rs.iterations))
    del logs
    print(f"quant: kmeans_train from one init: K6 {rk.iterations} "
          f"iterations, converged {rk.converged}, error {rk.final_error}; "
          f"plain {rs.iterations}, {rs.converged}, {rs.final_error}; "
          f"last centroids apart by {cerr} (tol {ctol}); K6's steps "
          f"against the plain step from their inputs: within "
          f"{held['step_err']}, {held['rows_off']} rows assigned apart "
          f"(largest gap {held['off_gap']}, tie limit {kchk.TIE}); the two "
          f"runs parted at step {held['parted_at']} (gap "
          f"{held['parting_gap']}), centroids within {held['apart']} "
          f"before", flush=True)
    if (rk.iterations != rs.iterations or rk.converged != rs.converged
            or abs(rk.final_error - rs.final_error) > 0.01 * rs.final_error
            or not kchk.lloyd_holds(held, ctol)
            or (held["parted_at"] is None and cerr > ctol)):
        fail("kmeans_train: K6's run differs from the plain run's")
    # the whole kmeans_train, warm, from the path's seed: its time and the
    # work its iterations did; the plain one from the same seed
    g = torch.Generator(device=dev)
    g.set_state(train_state)
    rw, kw_s = timed(lambda: km.kmeans_train(g, train, tmask, kc))
    _, plain_s = timed(lambda: km._lloyd_until(
        train, tmask, train[ppp[0].long()], 25, 1e-4, km.lloyd_block_plain))
    plain_s += pp_plain_s  # the plain k-means++ from the same seed
    pb, po = pp_work(nt, d, kc)
    lb, lo = lloyd_work(nt, d, kc, rw.iterations)
    bms, by = bound(pb + lb, po + lo)
    entry("kmeans_train", own(km_l, "kmeans_pp", "lloyd_block"),
          shape=f"N={nt} D={d} C={kc}, {rw.iterations} iterations",
          max_abs_err=held["step_err"], tol=ctol, error=rw.final_error,
          last_centroids_apart=cerr, parted_at=held["parted_at"],
          parting_gap=held["parting_gap"], rows_off=held["rows_off"],
          off_gap=held["off_gap"],
          plain_error=rs.final_error, ms=kw_s * 1e3, plain_ms=plain_s * 1e3,
          library_ms=None, bound_ms=bms, bound_by=by)
    del rk, rs, rw
    # K6 at PQ's training shape (M = 8: 48 dims), separated clusters with
    # one starting centroid each (near-tie rows would split otherwise)
    ds = d // 8
    crng = np.random.default_rng(13)
    centers = crng.standard_normal((kc, ds)).astype(np.float32) * 4
    xs = torch.from_numpy(centers[crng.integers(0, kc, nt)] + crng.
                          standard_normal((nt, ds)).astype(np.float32)).to(dev)
    init = torch.from_numpy(centers).to(dev)
    ck, ek = km.lloyd_block(xs, tmask, init, 5)
    cp, ep = km.lloyd_block_plain(xs, tmask, init, 5)
    err = float((ck - cp).abs().max())
    tol = 1e-5 * float(xs.abs().max())
    if err > tol or not torch.allclose(ek, ep, rtol=1e-4, atol=1e-3):
        fail(f"lloyd_block[pq M=8]: centroids off by {err} (tol {tol})")
    bms, by = bound(*lloyd_work(nt, ds, kc, 5))
    entry("lloyd_block[pq M=8]", own(pq[8]["train_l"], "lloyd_block"),
          shape=f"N={nt} C={kc} D={ds} steps=5", max_abs_err=err, tol=tol,
          ms=cuda_ms(torch, lambda: km.lloyd_block(xs, tmask, init, 5)),
          plain_ms=cuda_ms(torch, lambda: km.lloyd_block_plain(
              xs, tmask, init, 5)), library_ms=None, bound_ms=bms,
          bound_by=by)
    del xs, init, ck, cp

    # u8
    ck, mk, sk = qz.quantize_u8(x)
    cp, mp, sp = qz.quantize_u8_plain(x)
    err = max(float((ck.int() - cp.int()).abs().max()),
              float((mk - mp).abs().max()), float((sk - sp).abs().max()))
    if err != 0.0:
        fail(f"quantize_u8: codes, mins or scales off the plain version's "
             f"by {err}")
    del cp, mp, sp
    bms, by = bound(n * d * 4 + n * d + 8 * n, 4.0 * n * d)
    entry("quantize_u8", own(u8q_l, "quantize_u8"), shape=f"N={n} D={d}",
          max_abs_err=err, ms=cuda_ms(torch, lambda: qz.quantize_u8(x)),
          plain_ms=cuda_ms(torch, lambda: qz.quantize_u8_plain(x)),
          library_ms=None, bound_ms=bms, bound_by=by)
    yk = qz.dequantize_u8(ck, mk, sk)
    yp = qz.dequantize_u8_plain(ck, mk, sk)
    err = float((yk - yp).abs().max())
    if err != 0.0:
        fail(f"dequantize_u8: off the plain version by {err}")
    del yk, yp
    cf = ck.float()
    bms, by = bound(n * d + 8 * n + n * d * 4, 2.0 * n * d)
    entry("dequantize_u8", own(u8d_l, "dequantize_u8"), shape=f"N={n} D={d}",
          max_abs_err=err,
          ms=cuda_ms(torch, lambda: qz.dequantize_u8(ck, mk, sk)),
          plain_ms=cuda_ms(torch, lambda: qz.dequantize_u8_plain(ck, mk, sk)),
          library_ms=cuda_ms(torch, lambda: torch.addcmul(
              mk[:, None], cf, sk[:, None])), bound_ms=bms, bound_by=by)
    del ck, mk, sk, cf, u8c, u8m, u8s

    # PQ at both widths
    for m, r in pq.items():
        cents, codes, table = r["cb"].centroids, r["codes"], r["table"]
        ds = d // m
        # pq_train again from the path's seed, warm: its time and the work
        # its iterations did; the plain one from the same seed
        _, rows_p, pseed_s = pp_entry(f"kmeans_pp[M={m}]", r["train_l"], m)
        g = torch.Generator(device=dev)
        g.set_state(r["state"])
        (_, its, seed_s, lloyd_s), tk_s = timed(lambda: pq_train_from_state(
            torch, km, qz, g, train, m, kc, False))
        # the plain run from the plain k-means++ above (the same seed)
        init_p = train.reshape(nt, m, ds)[rows_p.long(), torch.arange(
            m, device=dev)[:, None]]
        (cb_p, _, _, plloyd_s), _ = timed(lambda: pq_train_from_state(
            torch, km, qz, None, train, m, kc, True, init_p))
        plain_s = pseed_s + plloyd_s
        print(f"quant: pq_train M={m}: {tk_s * 1e3:.3f} ms, seeding "
              f"{seed_s * 1e3:.3f} ms (one K7 launch), Lloyd "
              f"{lloyd_s * 1e3:.3f} ms ({m} subspaces, {sum(its)} "
              f"iterations); plain {plain_s * 1e3:.3f} ms: seeding "
              f"{pseed_s * 1e3:.3f} ms, Lloyd {plloyd_s * 1e3:.3f} ms "
              f"({card})", flush=True)
        dk = pq_distortion(torch, qz, cents, train)
        dp = pq_distortion(torch, qz, cb_p, train)
        if abs(dk - dp) > 0.01 * dp:
            fail(f"pq_train M={m}: distortion {dk} against the plain "
                 f"run's {dp}")
        work = [pp_work(nt, d, kc)] + [lloyd_work(nt, ds, kc, i)
                                       for i in its]
        bms, by = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        entry(f"pq_train[M={m}]", own(r["train_l"], "kmeans_pp",
                                      "lloyd_block"),
              shape=f"N={nt} D={d} M={m} K={kc}, {sum(its)} iterations",
              max_abs_err=abs(dk - dp), distortion=dk, plain_distortion=dp,
              ms=tk_s * 1e3, plain_ms=plain_s * 1e3, library_ms=None,
              seeding_ms=seed_s * 1e3, lloyd_ms=lloyd_s * 1e3,
              bound_ms=bms, bound_by=by)
        cp = qz.pq_encode_plain(cents, x)
        differ, gap = codes_check(torch, f"pq_encode[M={m}]", x, cents,
                                  codes, cp)
        del cp
        bms, by = bound(n * d * 4 + n * m + m * kc * ds * 4,
                        2.0 * n * kc * d)
        entry(f"pq_encode[M={m}]", own(r["enc_l"], "pq_encode"),
              shape=f"N={n} D={d} M={m} K={kc}", max_abs_err=gap,
              codes_differing_at_ties=differ,
              ms=cuda_ms(torch, lambda: qz.pq_encode(cents, x)),
              plain_ms=cuda_ms(torch, lambda: qz.pq_encode_plain(cents, x),
                               iters=2, warmup=1),
              library_ms=None, bound_ms=bms, bound_by=by)
        err = float((qz.pq_decode(cents, codes)
                     - qz.pq_decode_plain(cents, codes)).abs().max())
        if err != 0.0:
            fail(f"pq_decode[M={m}]: rows off the plain version's by {err}")
        bms, by = bound(n * m + m * kc * ds * 4 + n * d * 4, 0.0)
        entry(f"pq_decode[M={m}]", own(r["dec_l"], "pq_decode"),
              shape=f"N={n} D={d} M={m}", max_abs_err=err,
              ms=cuda_ms(torch, lambda: qz.pq_decode(cents, codes)),
              plain_ms=cuda_ms(torch, lambda: qz.pq_decode_plain(
                  cents, codes)), library_ms=None, bound_ms=bms, bound_by=by)
        tp_ = qz.pq_adc_table_plain(cents, q)
        err = float((table - tp_).abs().max())
        tol = 1e-5 * float(tp_.abs().max())
        if err > tol:
            fail(f"pq_adc_table[M={m}]: off by {err} (tol {tol})")
        bms, by = bound(b * d * 4 + m * kc * ds * 4 + b * m * kc * 4,
                        2.0 * b * kc * d)
        entry(f"pq_adc_table[M={m}]", own(r["tab_l"], "pq_adc_table"),
              shape=f"B={b} M={m} K={kc} Ds={ds}", max_abs_err=err, tol=tol,
              ms=cuda_ms(torch, lambda: qz.pq_adc_table(cents, q)),
              plain_ms=cuda_ms(torch, lambda: qz.pq_adc_table_plain(
                  cents, q)), library_ms=None, bound_ms=bms, bound_by=by)
        ak = qz.pq_adc_distances(table, codes)
        ap = qz.pq_adc_distances_plain(table, codes)
        err = float((ak - ap).abs().max())
        tol = 1e-5 * float(ap.abs().max())
        if err > tol:
            fail(f"pq_adc_distances[M={m}]: off by {err} (tol {tol})")
        del ak, ap
        bms, by = bound(b * n * 4 + n * m + b * m * kc * 4, 1.0 * b * n * m)
        entry(f"pq_adc_distances[M={m}]",
              own(r["scan_l"], "pq_adc_distances"),
              shape=f"B={b} N={n} M={m} K={kc}", max_abs_err=err, tol=tol,
              ms=cuda_ms(torch, lambda: qz.pq_adc_distances(table, codes)),
              plain_ms=cuda_ms(torch, lambda: qz.pq_adc_distances_plain(
                  table, codes)), library_ms=None, bound_ms=bms, bound_by=by)
    for m in pq:  # warm kernel times (the path's lines: first calls)
        perf.update({
            f"pq_encode_ms_m{m}": results[f"pq_encode[M={m}]"]["ms"],
            f"pq_adc_scan_ms_m{m}": results[f"pq_adc_distances[M={m}]"]["ms"]})
    for name in names:
        print_kernel(name, results[name], launch_of[name])
    del x, train, q, pq, exact
    gc.collect()
    torch.cuda.empty_cache()


PAR_BUILD_ROWS = 20_000  # the fresh HNSW built at S = 1 and at S = 4
PAR_INSERTS = 2_048  # ShardedBuilder inserts into the 1M graph at S = 4
PAR_SUBSET_LISTS = 16  # the IVF persistence check's lists
PAR_PLAIN_B = 32  # queries of K12's (range) check against its plain version


@contextlib.contextmanager
def plain_kernels(shd, ing):
    """parallel/'s kernel wrappers swapped for their plain versions, so a
    composition runs its plain version on the card."""
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.index import ivf as iv
    from fabstir_vectordb_tpu_torch.ops import kmeans as km
    from fabstir_vectordb_tpu_torch.ops import topk as tp

    swaps = [(shd, "l2_topk", tp.l2_topk_plain),
             (shd, "approx_topk", tp.approx_topk_plain),
             (shd, "rerank_f32", fu.rerank_f32_plain),
             (shd, "project_queries", fu.project_queries_plain),
             (shd, "ivf_scan", iv.ivf_scan_plain),
             (shd, "shard_merge", tp.shard_merge_plain),
             (shd, "lloyd_partial", km.lloyd_partial_plain),
             (shd, "lloyd_finish", km.lloyd_finish_plain),
             (shd, "greedy_descent", hn.greedy_descent_plain),
             (shd, "beam_search", hn.beam_search_plain),
             (ing, "assign_clusters", km.assign_clusters_plain),
             (ing, "_set_rows_true", ing._set_rows_true_plain)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, fn in swaps:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


# the merge's synthetic (S, k_s): each route by S * k_s (a warp to 64, a
# block's registers to 8,192 and to 16,384, the buffer past it)
MERGE_CASES = ((1, 10), (1, 64), (1, 200), (1, 2048), (4, 10), (4, 200),
               (4, 2048), (8, 10), (8, 200), (8, 2048), (5, 4000))


def merge_lists(torch, g, dev, s, b, ks):
    """s shards' sorted partial top-ks lists of b queries: signed
    distances, ties, a (+inf, -1) padded tail on every other query, and
    in mid-list -1 rows (with finite distances) and NaN distances, which
    never enter."""
    vals = torch.randn(s, b, ks, device=dev, generator=g) * 10
    vals[:, :, ::7] = vals[:, :, :1]
    vals, _ = torch.sort(vals, dim=-1)
    rows = torch.randint(0, 1 << 20, (s, b, ks), device=dev, generator=g,
                         dtype=torch.int32)
    pad = max(1, ks // 5)
    vals[:, 1::2, -pad:] = float("inf")
    rows[:, 1::2, -pad:] = -1
    hole = torch.rand(s, b, ks, device=dev, generator=g)
    rows[hole < 0.03] = -1
    vals[(hole > 0.5) & (hole < 0.51)] = float("nan")
    return vals.contiguous(), rows.contiguous()


def parallel_phase(torch, native, card: str, perf: dict, results: dict,
                   launch_of: dict, ctx: dict):
    """The multi-shard layer (K15, parallel/) on bench.py's 1M tier, one
    card: shard meshes of 4 (and 1, and 2 x 2) shards on it, and a NCCL
    process group of one rank. The path, counters from 0: the flat exact
    search (k = 10, 200; S = 4, 1, 2 x 2), the approx select, the projected
    stage 1 (ov_k = 2,048 on a rank-192 PCA mirror), the IVF search from the
    index's centroids and tiles (S = 4, 2 x 2), the Lloyd step (S = 4, 1),
    Lloyd to its stop rule, sharded_kmeans_train (C = 256, 1M rows),
    sharded_assign_clusters (1M rows, and one short of it from the host),
    the query-sharded HNSW (ef 64), the hybrid. Then: ShardedBuilder (a
    fresh 20,000-row HNSW at S = 1 and S = 4, 2,048 inserts into the 1M
    graph at S = 4), reshardable persistence, the NCCL mesh, the hard
    checks, and each new kernel and composition against its plain
    version."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from fabstir_vectordb_tpu_torch import parallel as pl
    from fabstir_vectordb_tpu_torch.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.index import ivf as iv
    from fabstir_vectordb_tpu_torch.index.store import VectorStore
    from fabstir_vectordb_tpu_torch.ops import kmeans as km
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.ops.projection import fit_pca
    from fabstir_vectordb_tpu_torch.parallel import ingest as ing
    from fabstir_vectordb_tpu_torch.parallel import sharded as shd
    from fabstir_vectordb_tpu_torch.parallel.mesh import DistMesh, LocalMesh
    from fabstir_vectordb_tpu_torch.utils import limits
    from fabstir_vectordb_tpu_torch.utils.padding import bucket
    from fabstir_vectordb_tpu_torch.utils.transfer import to_device

    h, x_np, n, d = ctx["h"], ctx["x"], ctx["n"], ctx["d"]
    dev = h.store.torch_device
    gc.collect()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mirror = h.store.device("float32")
    X, XSQ = mirror.x, mirror.x_sq
    cap = int(X.shape[0])
    rng = np.random.default_rng(21)
    act = h.store.active_mask(cap)
    dels = rng.choice(n, 1_000, replace=False)  # deleted / filtered rows
    mask_np = act.copy()
    mask_np[dels] = False
    M = to_device(mask_np, dev)
    ACT = to_device(act, dev)
    b = 128
    q_np = (x_np[rng.integers(0, n, b)] + 0.1 * rng.standard_normal(
        (b, d))).astype(np.float32)  # bench.py's draw: rows + 0.1 noise
    Q = to_device(q_np, dev)
    m1, m4 = LocalMesh(1), LocalMesh(4)
    m22 = LocalMesh((2, 2), ("data", "query"))
    cents_np = h.ivf.centroids
    tiles_np = h.ivf.tiles()
    c0 = to_device(cents_np, dev)

    # the reduced-rank state the projected search reads: a rank-192 PCA of
    # 65,536 rows, every row projected by K14 into a bf16 mirror
    rank = 192
    mu, p = fit_pca(x_np[:65_536], rank)
    mu_d, p_d = to_device(mu, dev), to_device(p, dev)
    XP = torch.empty((cap, rank), dtype=torch.bfloat16, device=dev)
    XP_SQ = torch.empty(cap, dtype=torch.float32, device=dev)
    for lo in range(0, cap, 1 << 18):
        hi = min(cap, lo + (1 << 18))
        fu.project_rows(X[lo:hi].to(torch.bfloat16), mu_d, p_d, XP, XP_SQ, lo)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def step(fn):
        before = dict(native.launches)
        out, sec = timed(fn)
        return out, sec, launch_delta(native, before)

    # ---- the path, counters from 0
    native.reset_launches()
    flat4, flat1 = pl.sharded_flat_search(m4), pl.sharded_flat_search(m1)
    r, sec, lau = {}, {}, {}
    for key, fn in (
            ("flat4", lambda: flat4(X, XSQ, M, Q, 10)),
            ("flat4_k200", lambda: flat4(X, XSQ, M, Q, 200)),
            ("flat1", lambda: flat1(X, XSQ, M, Q, 10)),
            ("flat22", lambda: pl.sharded_flat_search(
                m22, query_axis="query")(X, XSQ, M, Q, 10)),
            ("approx4", lambda: pl.sharded_flat_search(
                m4, select="approx")(X, XSQ, M, Q, 10)),
            ("proj4", lambda: pl.sharded_projected_search(m4)(
                XP, XP_SQ, M, mu_d, p_d, Q, 2048)),
            ("istate4", lambda: pl.shard_ivf_state(
                m4, cents_np, tiles_np, h.store.data, act)),
            ("istate22", lambda: pl.shard_ivf_state(
                m22, cents_np, tiles_np, h.store.data, act))):
        r[key], sec[key], lau[key] = step(fn)
    for key, fn in (
            ("ivf4", lambda: pl.sharded_ivf_search(m4)(r["istate4"], Q, 10,
                                                       16)),
            ("ivf22", lambda: pl.sharded_ivf_search(m22, query_axis="query")(
                r["istate22"], Q, 10, 16)),
            ("lloyd4", lambda: pl.sharded_lloyd_step(m4)(X[:n], M[:n], c0)),
            ("lloyd1", lambda: pl.sharded_lloyd_step(m1)(X[:n], M[:n], c0)),
            ("until4", lambda: shd.sharded_lloyd_until(m4, X[:n], M[:n], c0)),
            ("train4", lambda: pl.sharded_kmeans_train(m4, X[:n], M[:n], 256,
                                                       seed=0)),
            ("assign4", lambda: pl.sharded_assign_clusters(m4)(X[:n], c0)),
            ("assign4_host", lambda: pl.sharded_assign_clusters(m4)(
                x_np[:n - 1], c0)),
            ("hstate4", lambda: pl.shard_hnsw_state(m4, h.hnsw))):
        r[key], sec[key], lau[key] = step(fn)
    for key, fn in (
            ("hnsw4", lambda: pl.sharded_hnsw_search(m4)(r["hstate4"], Q, 10,
                                                         64)),
            ("hybrid4", lambda: pl.sharded_hybrid_search(m4)(
                r["hstate4"], r["istate4"], Q, 10, 64, 16))):
        r[key], sec[key], lau[key] = step(fn)
    counts = dict(native.launches)
    note_shapes("parallel-1m", native)
    path = ("l2_topk", "l2_topk_bf16_rq", "approx_topk_tf32",
            "rerank_f32_rows", "project_queries", "ivf_scan", "lloyd_partial",
            "lloyd_finish", "assign_clusters", "greedy_descent",
            "beam_search", "shard_merge")
    for name in path:
        if counts[name] <= 0:
            fail(f"parallel: {name} was launched no time on the path")
    print(f"parallel: path launches {dict((k, counts[k]) for k in path)}; "
          f"IVF state built in {sec['istate4']:.3f} s ({card})", flush=True)

    # ---- hard checks on the path's answers
    def same_rows(tag, va, ra, vb, rb, rel=1e-6, atol=0.0):
        """Equal (distance, row) lists up to ties: rows equal after sorting
        each query's pairs, distances within rel (and atol)."""
        va, ra, vb, rb = (t.cpu().numpy() for t in (va, ra, vb, rb))
        fin = np.isfinite(vb)
        if not (np.isfinite(va) == fin).all():
            fail(f"{tag}: padding differs")
        err = np.abs(np.where(fin, va - vb, 0.0))
        tol = rel * np.maximum(np.abs(np.where(fin, vb, 0.0)), 1.0) + atol
        if (err > tol).any():
            fail(f"{tag}: distances off by {float(err.max())}")
        oa, ob = np.lexsort((ra, va)), np.lexsort((rb, vb))
        ra_s = np.take_along_axis(ra, oa, 1)
        rb_s = np.take_along_axis(rb, ob, 1)
        differ = 0
        for i in np.nonzero((ra_s != rb_s).any(1))[0]:
            differ += 1
            kth = vb[i][fin[i]].max()
            for row in set(ra[i].tolist()) ^ set(rb[i].tolist()):
                dd = va[i][ra[i] == row] if row in set(ra[i].tolist()) \
                    else vb[i][rb[i] == row]
                if abs(float(dd[0]) - kth) > rel * max(abs(kth), 1.0) + atol:
                    fail(f"{tag}: query {i} row {row} differs off a tie")
        return float(err.max()), differ

    checks = {}
    for k, key in ((10, "flat4"), (200, "flat4_k200")):
        ref = tp.l2_topk(X, XSQ, M, Q, k)  # one K1 call over the mirror
        checks[key] = same_rows(f"flat S=4 k={k}", *r[key], *ref)
        if np.isin(r[key][1].cpu().numpy(), dels).any():
            fail(f"flat S=4 k={k}: a deleted row came back")
    ref10 = tp.l2_topk(X, XSQ, M, Q, 10)
    checks["flat1"] = same_rows("flat S=1", *r["flat1"], *ref10)
    checks["flat22"] = same_rows("flat 2x2", *r["flat22"], *r["flat4"])
    exact10 = ref10[1].cpu().numpy()
    rec_approx = recall(r["approx4"][1].cpu().numpy(), exact10)
    if rec_approx < 0.95 or np.isin(r["approx4"][1].cpu().numpy(),
                                    dels).any():
        fail(f"flat approx S=4: recall@10 {rec_approx} or a deleted row")
    # projected: the ov_k candidates hold single-device stage 1's top-10
    qp = fu.project_queries(Q, mu_d, p_d)
    _, s1 = fu.stage1_select(XP, XP_SQ, M, qp, 10)
    ov_proj = overlap(r["proj4"][1].cpu().numpy(), s1.cpu().numpy())
    if ov_proj < 0.99:
        fail(f"projected S=4: overlap {ov_proj} with stage 1's top-10")
    # IVF against one K12 over the index's lists
    lists = h.ivf.device_lists()
    imask = to_device(act & h.ivf.member_mask(cap), dev)
    iv_ref = iv.ivf_search(X, XSQ, imask, lists, Q, 10, 16)
    checks["ivf4"] = same_rows("IVF S=4", *r["ivf4"], *iv_ref[:2])
    checks["ivf22"] = same_rows("IVF 2x2", *r["ivf22"], *r["ivf4"])
    ist = r["istate4"]
    l_pad = int(tiles_np.shape[1])
    padded_gb = (256 * l_pad * (d * 4 + 4 + 1) + 256 * d * 4) / 1e9
    print(f"parallel: IVF shard state {ist.nbytes / 1e9:.3f} GB on the card "
          f"(packed lists) against {padded_gb:.3f} GB for the padded "
          f"[256, {l_pad}, {d}] layout ({card})", flush=True)
    # Lloyd: one step at S = 1 and 4 against one K6 step; to the stop rule
    # against single-device _lloyd_until from the same centroids
    cb, eb = km.lloyd_block(X[:n], M[:n], c0, 1)
    scale = float(X[:n].abs().max())
    # centroids within 1e-5 of the data scale. The error is a sum of 1M
    # f32 atomic adds: one accumulator (K6's block, S = 1) drifts from the
    # float64 sum by ~1e-4 relative, four (S = 4) by less, so each step's
    # error is held to the float64 sum: within 1e-4 of it, or no farther
    # than the block step's
    _, d2 = km.assign_clusters(X[:n], c0, M[:n])
    err64 = float(d2.double().sum()) / float(M[:n].sum())
    off_b = abs(float(eb[0]) - err64)
    for key in ("lloyd4", "lloyd1"):
        c_err = float((r[key][0] - cb[0]).abs().max())
        off = abs(float(r[key][1]) - err64)
        print(f"parallel: {key}: centroids {c_err} from one lloyd_block "
              f"step; error {float(r[key][1])} (block {float(eb[0])}, "
              f"float64 {err64})", flush=True)
        if c_err > 1e-5 * scale or off > max(1e-4 * err64, 1.01 * off_b):
            fail(f"{key}: off one lloyd_block step by {c_err} (centroids) "
                 f"or off the float64 error by {off / err64} relative")
    single, single_s = timed(lambda: km._lloyd_until(X[:n], M[:n], c0))
    c_sh, info = r["until4"]
    c_err = float((c_sh - single.centroids).abs().max())
    print(f"parallel: Lloyd to the stop rule S=4 {info['iterations']} "
          f"iterations, converged {info['converged']}, error "
          f"{info['final_error']} in {sec['until4']:.3f} s; single device "
          f"{single.iterations}, {single.converged}, {single.final_error} "
          f"in {single_s:.3f} s; centroids apart by {c_err} "
          f"(tol {1e-5 * scale})", flush=True)
    if (info["iterations"] != single.iterations
            or info["converged"] != single.converged
            or abs(info["final_error"] - single.final_error)
            > 0.01 * single.final_error or c_err > 1e-5 * scale):
        fail("sharded Lloyd differs from single-device _lloyd_until")
    t_c, t_info = r["train4"]
    if t_c.shape != (256, d) or not np.isfinite(t_info["final_error"]):
        fail(f"sharded_kmeans_train: {t_c.shape}, {t_info}")
    a_ref, _ = km.assign_clusters(X[:n], c0)
    if not torch.equal(r["assign4"], a_ref) \
            or not torch.equal(r["assign4_host"], a_ref[:n - 1]):
        fail("sharded_assign_clusters differs from one assignment call")
    # HNSW: the same rows as one K10 + K11 on the batch
    hs = r["hstate4"]
    cur, _ = hn.greedy_descent(hs.x, hs.x_sq, hs.mask, hs.nbrs_up,
                               hs.up_offset, Q, hs.entry, hs.entry_level,
                               torch.zeros(b, dtype=torch.int32, device=dev))
    _, h_rows = hn.beam_search(hs.x, hs.x_sq, hs.mask, hs.nbrs0, hs.nbrs_up,
                             hs.up_offset, Q, cur[:, None].contiguous(),
                             torch.ones(b, dtype=torch.bool, device=dev), 0,
                             64, 96, expand=limits.beam_expand())
    if not torch.equal(r["hnsw4"][1], h_rows[:, :10]):
        fail("sharded HNSW: rows differ from one K10 + K11 on the batch")
    exact_act = tp.l2_topk(X, XSQ, ACT, Q, 10)[1].cpu().numpy()
    rec_hybrid = recall(r["hybrid4"][1], exact_act)
    if rec_hybrid < 0.95:
        fail(f"sharded hybrid: recall@10 {rec_hybrid} < 0.95")
    print(f"parallel: checks passed: flat S=4 k=10 / 200 (max err, queries "
          f"differing at ties) {checks['flat4']} / {checks['flat4_k200']}, "
          f"S=1 {checks['flat1']}, 2x2 {checks['flat22']}; approx recall@10 "
          f"{rec_approx:.4f}; projected overlap {ov_proj:.4f}; IVF S=4 "
          f"{checks['ivf4']}, 2x2 {checks['ivf22']}; hybrid recall@10 "
          f"{rec_hybrid:.4f} ({card})", flush=True)

    # ---- speed (report only)
    def p50(fn, reps=100):
        ts = []
        for i in range(reps):
            qi = Q[i % b: i % b + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(qi)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    def qps(fn, calls=8):
        fn(Q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(Q)
        torch.cuda.synchronize()
        return calls * b / (time.perf_counter() - t0)

    ivf_fn = pl.sharded_ivf_search(m4)
    for s, fl in ((1, flat1), (4, flat4)):
        perf[f"sharded_flat_search_p50_ms_s{s}"] = p50(
            lambda qi: fl(X, XSQ, M, qi, 10))
        perf[f"sharded_flat_batched_qps_s{s}"] = qps(
            lambda qq: fl(X, XSQ, M, qq, 10))
    perf["sharded_ivf_batched_qps_s4"] = qps(
        lambda qq: ivf_fn(r["istate4"], qq, 10, 16))
    perf["sharded_hybrid_recall_at_10"] = rec_hybrid
    perf["sharded_kmeans_train_s"] = sec["train4"]
    perf["sharded_kmeans_train_iterations"] = t_info["iterations"]

    # ---- ShardedBuilder: a fresh graph at S = 1 and S = 4, then inserts
    # into the 1M graph at S = 4
    graphs = {}
    for s in (1, 4):
        st = VectorStore(d, device=dev)
        rows = st.add_batch([f"b{i}" for i in range(PAR_BUILD_ROWS)],
                            x_np[:PAR_BUILD_ROWS])
        g = hn.HNSWIndex(st, hn.HNSWConfig(seed=5))
        _, secs = timed(lambda: pl.ShardedBuilder(g, LocalMesh(s))
                        .insert_rows(rows))
        perf[f"sharded_build_20k_s_s{s}"] = secs
        graphs[s] = g
    g1, g4 = graphs[1], graphs[4]
    if (g1.entry_point != g4.entry_point or g1.max_level != g4.max_level
            or not np.array_equal(g1.levels, g4.levels)
            or not np.array_equal(g1.nbrs0, g4.nbrs0)
            or not np.array_equal(g1.nbrs_up, g4.nbrs_up)):
        rows_same = float((g1.nbrs0 == g4.nbrs0).all(1).mean())
        fail(f"ShardedBuilder: S=1 and S=4 adjacency differ ({rows_same} "
             f"of nbrs0 rows equal)")
    del graphs, g1, g4
    centers = ctx["centers"]
    ins = (centers[rng.integers(0, len(centers), PAR_INSERTS)]
           + 0.35 * rng.standard_normal((PAR_INSERTS, d))).astype(np.float32)
    new_rows = h.store.add_batch([f"par{i}" for i in range(PAR_INSERTS)],
                                 ins)
    builder = pl.ShardedBuilder(h.hnsw, m4)
    before = dict(native.launches)
    _, ins_s = timed(lambda: builder.insert_rows(new_rows))
    ins_l = launch_delta(native, before)
    _, found = h.hnsw.search_rows(ins, 1, ef=64)
    at1 = float((found[:, 0] == new_rows).mean())
    if at1 < 0.99 or ins_l.get("set_rows", 0) < 1:
        fail(f"ShardedBuilder: {at1} of {PAR_INSERTS} inserts at rank 1, "
             f"set_rows launches {ins_l.get('set_rows', 0)}")
    perf["sharded_insert_2048_s"] = ins_s
    print(f"parallel: ShardedBuilder {PAR_BUILD_ROWS} rows S=1 "
          f"{perf['sharded_build_20k_s_s1']:.3f} s, S=4 "
          f"{perf['sharded_build_20k_s_s4']:.3f} s, identical adjacency; "
          f"{PAR_INSERTS} inserts into the 1M graph at S=4 {ins_s:.3f} s, "
          f"{at1:.4f} at rank 1; launches {ins_l} ({card})", flush=True)
    del builder
    mirror = h.store.device("float32")  # the store grew: new rows
    X, XSQ = mirror.x[:cap], mirror.x_sq[:cap]

    # ---- persistence: flat saved at 4 shards, loaded at 2; IVF on a
    # 16-list subset
    m2 = LocalMesh(2)
    obj = MemoryObjectStore()
    _, save_s = timed(lambda: pl.save_sharded_flat(obj, "p/flat", X, XSQ, M,
                                                   m4))
    (x2, sq2, mk2), load_s = timed(lambda: pl.load_sharded_flat(
        obj, "p/flat", m2))
    v2, r2 = pl.sharded_flat_search(m2)(x2, sq2, mk2, Q, 10)
    vo, ro = pl.sharded_flat_search(m2)(X, XSQ, M, Q, 10)
    if not (torch.equal(v2, vo) and torch.equal(r2, ro)
            and torch.equal(r2, r["flat4"][1])):
        fail("flat persistence: the 2-shard load searches differently")
    del x2, sq2, mk2, obj
    live = (tiles_np[:PAR_SUBSET_LISTS] >= 0).sum(1)
    l16 = max(128, bucket(int(live.max()), minimum=128))
    t16 = np.ascontiguousarray(tiles_np[:PAR_SUBSET_LISTS, :l16])
    st16 = pl.shard_ivf_state(m4, cents_np[:PAR_SUBSET_LISTS], t16,
                              h.store.data, act)
    v16, r16 = pl.sharded_ivf_search(m4)(st16, Q, 10, 4)
    obj = MemoryObjectStore()
    pl.save_sharded_ivf(obj, "p/ivf", st16)
    st16b = pl.load_sharded_ivf(obj, "p/ivf", m2)
    v16b, r16b = pl.sharded_ivf_search(m2)(st16b, Q, 10, 4)
    if not (torch.equal(v16, v16b) and torch.equal(r16, r16b)):
        fail("IVF persistence: the 2-shard load searches differently")
    print(f"parallel: persistence: flat {cap} x {d} saved at 4 shards in "
          f"{save_s:.3f} s, loaded at 2 in {load_s:.3f} s, search "
          f"bit-identical; IVF {PAR_SUBSET_LISTS} lists (L_pad {l16}) saved "
          f"at 4, loaded at 2, search bit-identical", flush=True)
    del obj, st16, st16b

    # ---- a NCCL process group of one rank
    tmp = tempfile.mkdtemp(prefix="fvdb_nccl_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:  # the group and its store go whatever happens
        dm = pl.make_mesh(1)
        if not isinstance(dm, DistMesh):
            fail(f"make_mesh inside a process group gave {dm}")
        flat_d = pl.sharded_flat_search(dm)
        nv, nr = flat_d(X, XSQ, M, Q, 10)
        checks["nccl_flat"] = same_rows("NCCL flat", nv, nr, *r["flat1"])
        dstate = pl.shard_ivf_state(dm, cents_np, tiles_np, h.store.data,
                                    act)
        checks["nccl_ivf"] = same_rows("NCCL IVF", *pl.sharded_ivf_search(dm)(
            dstate, Q, 10, 16), *r["ivf4"])
        cn, en = pl.sharded_lloyd_step(dm)(X[:n], M[:n], c0)
        if float((cn - r["lloyd1"][0]).abs().max()) > 1e-5 * scale:
            fail("NCCL Lloyd step differs from LocalMesh(1)'s")
        del dstate
        perf["sharded_flat_nccl_w1_ms"] = cuda_ms(
            torch, lambda: flat_d(X, XSQ, M, Q, 10))
        perf["sharded_flat_local_s1_ms"] = cuda_ms(
            torch, lambda: flat1(X, XSQ, M, Q, 10))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"parallel: NCCL world 1: flat, IVF and a Lloyd step equal the "
          f"local mesh's; flat B=128 {perf['sharded_flat_nccl_w1_ms']:.3f} "
          f"ms against LocalMesh(1) {perf['sharded_flat_local_s1_ms']:.3f} "
          f"ms ({card})", flush=True)

    # ---- each new kernel and composition against its plain version
    names = []

    def entry(name, launches, **rr):
        if launches < 1:
            fail(f"parallel: {name} launched no time on the path")
        results[name] = rr
        launch_of[name] = launches
        names.append(name)

    g = torch.Generator(device=dev).manual_seed(22)
    worst = 0.0
    for s, ks in MERGE_CASES:
        vals, rows = merge_lists(torch, g, dev, s, b, ks)
        base = torch.arange(s, dtype=torch.int32, device=dev) << 21
        row_map = torch.randperm(s << 21, device=dev, generator=g).to(
            torch.int32)
        row_map[::29] = -1  # rows the map drops never enter
        for k, rm in ((10, None), (ks, None), (ks, row_map)):
            vk, rk = tp.shard_merge(vals, rows, k, base=base, row_map=rm)
            vp, rp = tp.shard_merge_plain(vals, rows, k, base=base,
                                          row_map=rm)
            what = f"shard_merge S={s} k_s={ks} k={k}" + (
                " row map" if rm is not None else "")
            if not torch.equal(rk, rp):
                fail(f"{what}: rows differ")
            fin = torch.isfinite(vp)
            if not torch.equal(fin, torch.isfinite(vk)):
                fail(f"{what}: padding differs")
            worst = max(worst, float((vk - vp)[fin].abs().max())
                        if fin.any() else 0.0)
    if worst != 0.0:
        fail(f"shard_merge: distances off the plain version's by {worst}")

    def merge_entry(tag, parts, k, base, row_map, launches):
        vals = torch.stack([t[0] for t in parts]).contiguous()
        rows = torch.stack([t[1] for t in parts]).contiguous()
        s, bb, ks = vals.shape
        vk, rk = tp.shard_merge(vals, rows, k, base=base, row_map=row_map)
        vp, rp = tp.shard_merge_plain(vals, rows, k, base=base,
                                      row_map=row_map)
        if not torch.equal(rk, rp):
            fail(f"shard_merge[{tag}]: rows differ from the plain version")
        fin = torch.isfinite(vp)
        err = float((vk - vp)[fin].abs().max()) if fin.any() else 0.0
        flat_v = vals.permute(1, 0, 2).reshape(bb, s * ks).contiguous()
        nbytes = s * bb * ks * 8 + bb * k * 8 + s * 4 + (
            s * bb * ks * 4 if row_map is not None else 0)
        bms, by = bound(nbytes, float(s * bb * ks), INT32_OPS)

        def merge():
            return tp.shard_merge(vals, rows, k, base=base, row_map=row_map)

        def topk():
            return torch.topk(flat_v, k, dim=1, largest=False)

        # ms: back-to-back calls, the cost a call adds to the path (at
        # these sizes host time as much as card time), as for torch.topk;
        # beside them the card's time of one call (events around each of
        # 20 calls queued behind a sleep; the median) and the host
        # microseconds a call
        entry(f"shard_merge[{tag}]", launches,
              shape=f"S={s} B={bb} k_s={ks} k={k}"
              + (" row map" if row_map is not None else ""),
              max_abs_err=max(err, worst),
              synthetic_cases=3 * len(MERGE_CASES),
              ms=cuda_ms(torch, merge),
              plain_ms=cuda_ms(torch, lambda: tp.shard_merge_plain(
                  vals, rows, k, base=base, row_map=row_map)),
              library_ms=cuda_ms(torch, topk),
              device_us=float(np.median(device_us_each(torch,
                                                       [merge] * 20))),
              library_device_us=float(np.median(device_us_each(
                  torch, [topk] * 20))),
              host_us=host_us(torch, merge, 2000),
              library_host_us=host_us(torch, topk, 2000),
              bound_ms=bms, bound_by=by)

    sl4 = m4.shard_slices(cap, "data")
    bases4 = torch.arange(4, dtype=torch.int32, device=dev) * (cap // 4)
    merge_entry("search", [tp.l2_topk(X[s], XSQ[s], M[s], Q, 10)
                           for s in sl4], 10, bases4, None,
                lau["flat4"].get("shard_merge", 0))
    qb = X[:1024].contiguous()  # the builder's batch shape
    merge_entry("build", [tp.l2_topk(X[s], XSQ[s], M[s], qb, 200)
                          for s in sl4], 200, bases4, None,
                ins_l.get("shard_merge", 0))
    qr = fu.project_queries(Q, mu_d, p_d).to(torch.bfloat16).float()
    merge_entry("projected", [tp.l2_topk(XP[s], XP_SQ[s], M[s], qr, 2048,
                                         round_query=True) for s in sl4],
                2048, bases4, None, lau["proj4"].get("shard_merge", 0))
    probe = tp.l2_topk(ist.centroids, ist.c_sq, None, Q, 16)[1]
    merge_entry("ivf", [iv.ivf_scan(sh.x, sh.x_sq, sh.valid, sh.lists, probe,
                                    Q, 10, c_lo=sh.c_lo)
                        for _, sh in sorted(ist.shards.items())], 10,
                ist.map_base, ist.row_map, lau["ivf4"].get("shard_merge", 0))

    # set-rows
    mk = (torch.rand(cap, device=dev, generator=g) < 0.5)
    srows = torch.randint(0, cap, (1024,), device=dev, generator=g,
                          dtype=torch.int32)
    want = ing._set_rows_true_plain(mk.clone(), srows)
    got = ing._set_rows_true(mk.clone(), srows)
    if not torch.equal(got, want):
        fail("set_rows: differs from the plain version")
    true_t = torch.ones(1024, dtype=torch.bool, device=dev)
    bms, by = bound(1024 * 4 + 1024, 1024.0, INT32_OPS)
    entry("set_rows", ins_l.get("set_rows", 0), shape=f"N={cap} rows=1024",
          max_abs_err=float((got.int() - want.int()).abs().max()),
          ms=cuda_ms(torch, lambda: ing._set_rows_true(mk, srows)),
          plain_ms=cuda_ms(torch, lambda: ing._set_rows_true_plain(mk, srows)),
          library_ms=cuda_ms(torch, lambda: mk.index_put_(
              (srows.long(),), true_t)), bound_ms=bms, bound_by=by)

    # K6 split: partial + finish at S = 1 against one lloyd_block step
    xs, ms_ = X[:n], M[:n]
    sums, cnts, stats = km.lloyd_partial(xs, ms_, c0)
    ck, ek = km.lloyd_finish(sums, cnts, stats, c0)
    sp, cp_, stp = km.lloyd_partial_plain(xs, ms_, c0)
    cpl, epl = km.lloyd_finish_plain(sp, cp_, stp, c0)
    err_p = float((ck - cb[0]).abs().max())
    if err_p > 1e-5 * scale or float((ck - cpl).abs().max()) > 1e-5 * scale:
        fail(f"lloyd_partial + finish: off one step by {err_p}")
    bms, by = bound(*lloyd_work(n, d, 256, 1))
    entry("lloyd_partial", lau["lloyd4"].get("lloyd_partial", 0),
          shape=f"N={n} C=256 D={d} (one shard: S=1)", max_abs_err=err_p,
          tol=1e-5 * scale,
          ms=cuda_ms(torch, lambda: km.lloyd_partial(xs, ms_, c0)),
          plain_ms=cuda_ms(torch, lambda: km.lloyd_partial_plain(
              xs, ms_, c0), iters=2, warmup=1),
          library_ms=None, bound_ms=bms, bound_by=by)
    bms, by = bound(256 * d * 4 * 3 + 256 * 4 + 8, 256.0 * d)
    entry("lloyd_finish", lau["lloyd4"].get("lloyd_finish", 0),
          shape=f"C=256 D={d}",
          max_abs_err=float((ck - cpl).abs().max()),
          ms=cuda_ms(torch, lambda: km.lloyd_finish(sums, cnts, stats, c0)),
          plain_ms=cuda_ms(torch, lambda: km.lloyd_finish_plain(
              sums, cnts, stats, c0)),
          library_ms=None, bound_ms=bms, bound_by=by)

    # K12 with a list range on each shard
    qs = Q[:PAR_PLAIN_B].contiguous()
    pr = probe[:PAR_PLAIN_B].contiguous()
    worst_r, differ_r = 0.0, 0
    for s, sh in sorted(ist.shards.items()):
        vk, rk = iv.ivf_scan(sh.x, sh.x_sq, sh.valid, sh.lists, pr, qs, 10,
                             c_lo=sh.c_lo)
        vp, rp = iv.ivf_scan_plain(sh.x, sh.x_sq, sh.valid, sh.lists, pr, qs,
                                   10, c_lo=sh.c_lo)
        tol = 2e-5 * float(sh.x_sq.max() + (qs * qs).sum(1).max())
        e, df = topk_check(f"ivf_scan[shard {s}]", vk, rk, vp, rp, tol)
        worst_r, differ_r = max(worst_r, e), differ_r + df
    # shard 0's work on the path's probes: each probed list it owns read
    # once, each (query, live row) pair scored
    sh0 = ist.shards[0]
    tl = sh0.lists.tiles
    live = ((tl >= 0) & sh0.valid[tl.clamp_min(0).long()]).sum(1)
    loc = probe.long() - sh0.c_lo
    own = (loc >= 0) & (loc < sh0.c_local)
    pairs = int(live[loc.clamp(0, sh0.c_local - 1)][own].sum())
    union = loc[own].unique()
    bms, by = bound(int(live[union].sum()) * (d * 4 + 4)
                    + int(sh0.lists.list_len[union].sum()) * 5
                    + b * (d * 4 + 16 * 4 + 80), 2.0 * d * pairs)
    entry("ivf_scan[shard range]", lau["ivf4"].get("ivf_scan", 0),
          shape=f"B={b} n_probe=16 k=10, shard 0 of 4 ({sh0.x.shape[0]} "
          f"rows, lists {sh0.c_lo}-{sh0.c_lo + sh0.c_local - 1})",
          max_abs_err=worst_r, rows_differing_at_ties=differ_r,
          ms=cuda_ms(torch, lambda: iv.ivf_scan(
              sh0.x, sh0.x_sq, sh0.valid, sh0.lists, probe, Q, 10,
              c_lo=sh0.c_lo)),
          plain_ms=cuda_ms(torch, lambda: iv.ivf_scan_plain(
              sh0.x, sh0.x_sq, sh0.valid, sh0.lists, probe, Q, 10,
              c_lo=sh0.c_lo), iters=1, warmup=1),
          library_ms=None, bound_ms=bms, bound_by=by,
          stage_us=k12_stage_us(torch, lambda: iv.ivf_scan(
              sh0.x, sh0.x_sq, sh0.valid, sh0.lists, probe, Q, 10,
              c_lo=sh0.c_lo)),
          modelled_reads=k12_reads(torch, sh0.lists, sh0.valid, probe, d, 4,
                                   c_lo=sh0.c_lo))

    # the compositions: the path's calls, then the same with every kernel
    # swapped for its plain version
    n_in = int(M.sum())
    # check: "rows" (equal up to ties), "overlap" (mean overlap >= 0.99:
    # K9's pool and the walks meet near-ties, and the plain query
    # projection may round an element to the next bf16), "cents", "assign"
    comps = [
        ("sharded_flat_search[S=4 k=10]", "flat4", "rows",
         lambda: flat4(X, XSQ, M, Q, 10),
         route_bound(cap * d * 4 + cap * 5 + b * d * 4 + b * 80,
                     2.0 * b * n_in * d, fu.tile_route(X.dtype, False, d))),
        ("sharded_flat_search[S=1 k=10]", "flat1", "rows",
         lambda: flat1(X, XSQ, M, Q, 10),
         route_bound(cap * d * 4 + cap * 5 + b * d * 4 + b * 80,
                     2.0 * b * n_in * d, fu.tile_route(X.dtype, False, d))),
        ("sharded_flat_search[approx S=4 k=10]", "approx4", "overlap",
         lambda: pl.sharded_flat_search(m4, select="approx")(X, XSQ, M, Q,
                                                              10),
         route_bound(cap * d * 4 + cap * 5 + b * d * 4 + b * 80,
                     2.0 * b * n_in * d, fu.tile_route(X.dtype, False, d))),
        ("sharded_projected_search[S=4 ov_k=2048]", "proj4", "overlap",
         lambda: pl.sharded_projected_search(m4)(XP, XP_SQ, M, mu_d, p_d, Q,
                                                 2048),
         bound(cap * rank * 2 + cap * 5 + b * d * 4 + d * rank * 4
               + b * 2048 * 8, 2.0 * b * n_in * rank, BF16_FLOPS)),
        ("sharded_ivf_search[S=4]", "ivf4", "rows",
         lambda: ivf_fn(r["istate4"], Q, 10, 16),
         bound(*ivf_work(lists, imask, iv_ref[2], b, 10, d, 4)[:2])),
        ("sharded_lloyd_step[S=4]", "lloyd4", "cents",
         lambda: pl.sharded_lloyd_step(m4)(X[:n], M[:n], c0),
         bound(*lloyd_work(n, d, 256, 1))),
        ("sharded_assign_clusters[S=4]", "assign4", "assign",
         lambda: pl.sharded_assign_clusters(m4)(X[:n], c0),
         bound(n * d * 4 + 256 * d * 4 + n * 4, 2.0 * n * 256 * d)),
        ("sharded_hnsw_search[S=4]", "hnsw4", "overlap",
         lambda: pl.sharded_hnsw_search(m4)(r["hstate4"], Q, 10, 64), None),
    ]
    gst, bst = {}, {}
    gd = hn.greedy_descent_plain(hs.x, hs.x_sq, hs.mask, hs.nbrs_up,
                                 hs.up_offset, Q, hs.entry, hs.entry_level,
                                 stats=gst)[0]
    hn.beam_search_plain(hs.x, hs.x_sq, hs.mask, hs.nbrs0, hs.nbrs_up,
                         hs.up_offset, Q, gd[:, None], None, 0, 64, 96,
                         expand=limits.beam_expand(), stats=bst)
    seen = int((gst["seen"] | bst["seen"]).sum())
    hnsw_bound = bound(seen * (d * 4 + 4 + 1) + bst["parents"] * 32 * 4
                       + b * d * 4 + b * 80,
                       (gst["rows"] + bst["rows"]) * 2.0 * d)
    # kernel against plain: f32 sums in another order, so distances within
    # 2e-5 of the norms they cancel (the kernels phase's K1 tolerance)
    atol_rows = 2e-5 * float(XSQ.max() + (Q * Q).sum(1).max())
    for name, key, mode, fn, bnd in comps:
        bms, by = bnd if bnd is not None else hnsw_bound
        ms = cuda_ms(torch, fn, iters=3, warmup=1)
        with plain_kernels(shd, ing):
            pout = fn()
            pms = cuda_ms(torch, fn, iters=1, warmup=0)
        kout = fn()
        extra = {}
        if mode == "rows":
            err, extra["rows_differing_at_ties"] = same_rows(
                name, kout[0], kout[1], pout[0], pout[1], rel=1e-5,
                atol=atol_rows)
        elif mode == "overlap":
            ka, pa = kout[1].cpu().numpy(), pout[1].cpu().numpy()
            extra["overlap"] = overlap(ka, pa)
            if extra["overlap"] < 0.99:
                fail(f"{name}: overlap {extra['overlap']} with plain")
            both = (kout[1] == pout[1]) & (kout[1] >= 0)
            err = float((kout[0] - pout[0])[both].abs().max()) \
                if bool(both.any()) else 0.0
        elif mode == "cents":
            err = float((kout[0] - pout[0]).abs().max())
            if err > 1e-5 * scale:
                fail(f"{name}: off its plain version by {err}")
        else:
            err = float((kout != pout).sum())
            if err:
                fail(f"{name}: {err} assignments differ from plain")
        entry(name, sum(lau[key].values()), shape=f"B={b}, N={cap}" if key
              not in ("lloyd4", "assign4") else f"N={n} C=256",
              max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
              bound_ms=bms, bound_by=by, **extra)
        del pout, kout
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    perf["parallel_device_peak_gb"] = peak
    mine = {k: v for k, v in perf.items() if k.startswith("sharded_")}
    print(f"parallel: metrics {json.dumps(mine, default=float)}; phase "
          f"device peak {peak:.3f} GB above the {base_mem / 1e9:.3f} GB "
          f"held ({card})", flush=True)
    for name in names:
        print_kernel(name, results[name], launch_of[name])
    del r, ist, hs, mirror, X, XSQ  # the store keeps its own mirror
    gc.collect()
    torch.cuda.empty_cache()


COLD_CHUNK = 10_000  # rows a chunk of the save (the persister's default)
COLD_QUERIES = 32  # near-row queries held to the exact answers
COLD_FULL_PROBE = 8  # queries that probe every list: the warm answers
COLD_INSERTS = 2_048  # rows inserted after the load (the pipelined build)
COLD_IVF_ROWS = 65_536  # the IVF index migrate_index retrains
COLD_OPS_QUERIES = 128  # the ops entry points' distance matrix [B, N]


def exact_top(torch, x, live, q, k: int, chunk: int = 262_144):
    """Exact float64 top-k of q [B, D] over the rows x [N, D] where live
    ([N] or [B, N] bool), on the card: (distances [B, k], rows [B, k]) as
    numpy."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    qd = torch.from_numpy(np.ascontiguousarray(q)).to(dev).double()
    q_sq = (qd * qd).sum(1)
    best_d = torch.full((q.shape[0], k), float("inf"), dtype=torch.float64,
                        device=dev)
    best_r = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
    for lo in range(0, x.shape[0], chunk):
        xb = torch.from_numpy(np.ascontiguousarray(x[lo:lo + chunk])).to(
            dev).double()
        d = (xb * xb).sum(1)[None, :] - 2.0 * (qd @ xb.T) + q_sq[:, None]
        m = torch.from_numpy(np.ascontiguousarray(
            live[..., lo:lo + chunk])).to(dev)
        d = torch.where(m if m.dim() == 2 else m[None, :], d.clamp_min(0.0),
                        torch.full_like(d, float("inf")))
        v, r = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        cd, cr = torch.cat([best_d, v], 1), torch.cat([best_r, r + lo], 1)
        order = torch.argsort(cd, dim=1, stable=True)[:, :k]
        best_d, best_r = cd.gather(1, order), cr.gather(1, order)
    best_r = torch.where(torch.isfinite(best_d), best_r,
                         torch.full_like(best_r, -1))
    return best_d.sqrt().cpu().numpy(), best_r.cpu().numpy()


def as_ids(store, rows):
    return np.array([[store.id_of(int(r)) if r >= 0 else "" for r in row]
                     for row in rows])


def same_by_id(tag, d_got, ids_got, d_want, ids_want, tol):
    """Two top-k lists of ids equal up to ties: each query's distances
    agree within tol position by position, and an id in one list only
    ties the k-th distance within tol."""
    for i in range(d_got.shape[0]):
        if not np.allclose(d_got[i], d_want[i], rtol=0, atol=tol,
                           equal_nan=True):
            fail(f"{tag}: query {i} distances {d_got[i]} vs {d_want[i]}")
        a, b = set(ids_got[i]) - {""}, set(ids_want[i]) - {""}
        kth = float(np.nanmax(np.where(np.isfinite(d_want[i]), d_want[i],
                                       np.nan)))
        for vid in a ^ b:
            src_d, src_i = (d_got, ids_got) if vid in a else (d_want,
                                                             ids_want)
            dv = float(src_d[i][list(src_i[i]).index(vid)])
            if abs(dv - kth) > tol:
                fail(f"{tag}: query {i} id {vid} differs off a tie")


def cold_phase(torch, native, card: str, perf: dict, results: dict,
               launch_of: dict, ctx: dict):
    """Persistence and lazy cold loading (bench.py's bench_cold_serve,
    bench.py:415-516) on the 1M index: the chunked save to a
    MemoryObjectStore; a lazy load (sidecars only), the first search
    answered by on-demand fetches while the rows materialize behind it
    (their uploads staged on a side stream), the cold answers against the
    exact ones over their plan and, probing every list, against the warm
    index; 2,048 inserts into the loaded index through the pipelined
    build (B1); an eager bf16 load, prewarm and first search against a
    float64 brute force; the ops entry points (B2-B4) over the loaded
    rows; IVFPersister.migrate_index of a 65,536-row IVF index to twice
    its lists. The counters, from 0, must show B1-B4."""
    import gc

    from fabstir_vectordb_tpu_torch import ops
    from fabstir_vectordb_tpu_torch.core.object_store import MemoryObjectStore
    from fabstir_vectordb_tpu_torch.index.hybrid import SearchConfig
    from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig, IVFIndex
    from fabstir_vectordb_tpu_torch.index.store import VectorStore
    from fabstir_vectordb_tpu_torch.ops.topk import masked_approx_topk
    from fabstir_vectordb_tpu_torch.storage.persistence import (
        HybridPersister, IVFPersister)

    h, x, d = ctx["h"], ctx["x"], ctx["d"]
    cfg = SearchConfig(auto_migrate=False)
    for key in ("FVDB_SERVING_DTYPE", "FVDB_FLAT_SELECT", "FVDB_PCA_SERVE",
                "FVDB_FLAT_THRESHOLD"):
        os.environ.pop(key, None)
    if h.fused.serving_info()["regime"] != "flat-exact":
        fail(f"cold: the 1M index serves {h.fused.serving_info()}")
    # the warm index keeps its host rows only: its device state goes first
    h.store.release_mirror()
    h.fused._dev = None
    h.fused._key = None
    h.fused._release_proj()
    gc.collect()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hs = h.store
    n_live = hs.active_count
    rng = np.random.default_rng(21)
    native.reset_launches()

    mem = MemoryObjectStore()
    t = time.perf_counter()
    manifest = HybridPersister(mem).save_index_chunked(h, "cold",
                                                       chunk_size=COLD_CHUNK)
    save_s = time.perf_counter() - t
    saved_bytes = sum(len(mem.get(k)) for k in mem.list_keys("cold/"))

    # ---- lazy: sidecars, then the first search through cold serving
    t0 = time.perf_counter()
    lz, _ = HybridPersister(mem).load_index_chunked("cold", lazy=True)
    sidecar_s = time.perf_counter() - t0
    if lz.ready or lz._cold is None:
        fail("cold: the lazy load came back resident")
    probe = int(0.6 * x.shape[0])
    t = time.perf_counter()
    dd, rr = lz.search_rows(x[probe], 10, config=cfg, now=NOW)
    first_s = time.perf_counter() - t
    first_stats = lz._cold.stats() if lz._cold is not None else {}
    if lz.store.id_of(int(rr[0, 0])) != f"v{probe}" or dd[0, 0] > 1e-2:
        fail(f"cold: the first search missed its own row ({dd[0, :3]})")
    # the checks run with the materializer parked, so they go through
    # cold serving; their time is kept out of the materialization's
    cold = lz._cold
    t_hold = time.perf_counter()
    held = cold is not None and not lz.ready
    if held:
        cold.hold_materializer()
    try:
        if lz.ready:
            fail("cold: materialized before the checks could run cold")
        qi = rng.choice(x.shape[0], COLD_QUERIES, replace=False)
        q = (x[qi] + 0.05 * rng.standard_normal((COLD_QUERIES, d))
             ).astype(np.float32)
        dc, rc = lz.search_rows(q, 10, config=cfg, now=NOW)
        # exact over each query's plan: the HNSW span and its probed lists
        spans = cold._merged_spans(cold._probe_spans(q, h.config.ivf.n_probe))
        cand = np.concatenate([np.arange(a, b) for a, b in spans])
        ids = [lz.store.id_of(int(p)) for p in cand]
        hrows = np.array([hs.row_of(v) for v in ids])
        inside = np.zeros((COLD_QUERIES, cand.size), bool)
        for i in range(COLD_QUERIES):
            for a, b in cold._merged_spans(cold._probe_spans(
                    q[i:i + 1], h.config.ivf.n_probe)):
                inside[i] |= (cand >= a) & (cand < b)
        de, re = exact_top(torch, hs.data[hrows],
                           inside & ~hs.deleted[hrows][None, :], q, 10)
        same_by_id("cold queries (their plans)", dc, as_ids(lz.store, rc), de,
                   np.array([[ids[j] if j >= 0 else "" for j in row]
                             for row in re]), 1e-3)
        # probing every list the plan is every row: the warm index's
        qf = q[:COLD_FULL_PROBE]
        dfc, rfc = lz.search_rows(qf, 10, config=SearchConfig(
            auto_migrate=False, ivf_n_probe=h.ivf.centroids.shape[0]),
            now=NOW)
        if lz.ready:
            fail("cold: the full-probe check did not run cold")
        dw, rw = h.search_rows(qf, 10, config=cfg, now=NOW)
        same_by_id("cold (every list) against the warm index", dfc,
                   as_ids(lz.store, rfc), dw, as_ids(hs, rw), 1e-3)
        cold_stats = cold.stats()
    finally:
        if held:
            cold.release_materializer()
    held_s = time.perf_counter() - t_hold
    lz.wait_ready(timeout=600)
    materialize_s = time.perf_counter() - t0 - held_s
    m = lz.store._mirror
    if m is None or m.version != lz.store._version \
            or (m.x.is_cuda and m.ready is None):
        fail("cold: the materializer did not install its staged mirror")
    dl, rl = lz.search_rows(qf, 10, config=cfg, now=NOW)
    same_by_id("loaded (resident) against the warm index", dl,
               as_ids(lz.store, rl), dw, as_ids(hs, rw), 1e-3)
    print(f"cold: save {save_s:.3f} s ({manifest.num_chunks} chunks, "
          f"{saved_bytes / 1e9:.3f} GB); lazy serve-ready {sidecar_s:.3f} "
          f"s, first search {first_s:.3f} s {first_stats}; materialized "
          f"{materialize_s:.3f} s (checks held {held_s:.3f} s); cold checks "
          f"{cold_stats} ({card})", flush=True)

    # ---- inserts after the load: the pipelined build (B1)
    base = rng.choice(x.shape[0], COLD_INSERTS, replace=False)
    xn = (x[base] + 0.05 * rng.standard_normal((COLD_INSERTS, d))
          ).astype(np.float32)
    new_ids = [f"cold-new-{i}" for i in range(COLD_INSERTS)]
    t = time.perf_counter()
    lz.insert_batch(new_ids, xn, np.full(COLD_INSERTS, NOW), now=NOW)
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t
    _, rn = lz.search_rows(xn, 1, config=cfg, now=NOW)
    found = float(np.mean([lz.store.id_of(int(r)) == v
                           for r, v in zip(rn[:, 0], new_ids)]))
    if found < 0.99:
        fail(f"cold: {found:.4f} of the inserts found at rank 1")

    # ---- the ops entry points over the loaded rows (B2-B4)
    mirror = lz.store.device("float32")
    n_rows = lz.store.count
    live_rows = torch.from_numpy(lz.store.active_mask(n_rows)).to(
        mirror.x.device)
    qo = x[rng.choice(x.shape[0], COLD_OPS_QUERIES, replace=False)] \
        + 0.05 * rng.standard_normal((COLD_OPS_QUERIES, d)).astype(np.float32)
    qd = torch.from_numpy(qo.astype(np.float32)).to(mirror.x.device)
    dmat = ops.pairwise_sq_l2(qd, mirror.x[:n_rows], mirror.x_sq[:n_rows])
    vt, rt = ops.masked_topk(dmat, live_rows, 10)
    va, ra = masked_approx_topk(dmat, live_rows, 128)
    torch.cuda.synchronize()
    de, re = exact_top(torch, lz.store.data[:n_rows],
                       lz.store.active_mask(n_rows), qo, 10)
    same_by_id("ops.masked_topk against float64", np.sqrt(np.maximum(
        vt.cpu().numpy(), 0.0)), rt.cpu().numpy().astype(str), de,
        re.astype(str), 1e-3)
    pool = ra.cpu().numpy()
    approx_recall = float(np.mean([len(set(re[i]) & set(pool[i])) / 10
                                   for i in range(len(re))]))
    if approx_recall < 0.95:
        fail(f"ops.masked_approx_topk: pool recall@10 {approx_recall}")
    del dmat, vt, rt, va, ra

    # ---- IVFPersister.migrate_index: 64 -> 128 lists, retrained on the card
    st = VectorStore(d)
    ivf_rows = st.add_batch([f"r{i}" for i in range(COLD_IVF_ROWS)],
                            x[:COLD_IVF_ROWS])
    ivf = IVFIndex(st, IVFConfig(n_clusters=64, n_probe=8,
                                 train_size=COLD_IVF_ROWS, seed=0))
    ivf.train(x[:COLD_IVF_ROWS])
    ivf.insert_rows(ivf_rows)
    for i in range(0, COLD_IVF_ROWS, 97):
        st.mark_deleted(f"r{i}")
    ip = IVFPersister(mem)
    ip.save_index(ivf, "ivf64")
    t = time.perf_counter()
    ip.migrate_index("ivf64", IVFConfig(n_clusters=128, n_probe=8,
                                        train_size=COLD_IVF_ROWS, seed=0),
                     "ivf128")
    torch.cuda.synchronize()
    migrate_s = time.perf_counter() - t
    st2, ivf2 = ip.load_index("ivf128")
    if ivf2.centroids.shape != (128, d) \
            or ivf2.member_rows().size != st2.active_count:
        fail(f"migrate_index: {ivf2.centroids.shape}, "
             f"{ivf2.member_rows().size} members of {st2.active_count}")
    xs_t = torch.from_numpy(st2.data[: st2.count]).to(mirror.x.device)
    live2 = torch.from_numpy(st2.active_mask(st2.count)).to(xs_t.device)
    errs = {}
    for tag, cents in (("64", ivf.centroids), ("128", ivf2.centroids)):
        ct = torch.from_numpy(cents).to(xs_t.device)
        _, e = ops.lloyd_step(xs_t, live2, ct)
        errs[tag] = float(e)
    if not errs["128"] < errs["64"]:
        fail(f"migrate_index: error {errs} did not fall at 128 lists")
    _, rself = ivf2.search_rows(st2.data[:64], 1, n_probe=8)
    lives = st2.active_mask(64)
    if np.mean(rself[lives, 0] == np.arange(64)[lives]) < 0.99:
        fail("migrate_index: the migrated lists miss their own rows")
    torch.cuda.synchronize()

    # ---- eager bf16: prewarm + first search (bench.py's path B)
    del lz, mirror, live_rows, qd, xs_t, live2
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["FVDB_SERVING_DTYPE"] = "bfloat16"
    try:
        t = time.perf_counter()
        eg, _ = HybridPersister(mem).load_index_chunked("cold", lazy=False)
        eager_s = time.perf_counter() - t
        t = time.perf_counter()
        eg.fused.prewarm()
        eg.search_rows(np.zeros((1, d), np.float32), 10, config=cfg, now=NOW)
        serve_s = time.perf_counter() - t
        if eg.store._mirror is None or eg.store._mirror.dtype != "bfloat16":
            fail("cold: the eager load holds no bf16 mirror")
        de_b, re_b = eg.search_rows(q, 10, config=cfg, now=NOW)
        live_h = hs.active_mask(hs.count)
        dx, rx = exact_top(torch, hs.data[: hs.count], live_h, q, 10)
        same_by_id("eager bf16 load against float64", de_b,
                   as_ids(eg.store, re_b), dx, as_ids(hs, rx), 1e-3)
    finally:
        os.environ.pop("FVDB_SERVING_DTYPE", None)
    torch.cuda.synchronize()
    counts = {k: v for k, v in native.launches.items() if v}
    note_shapes("cold-1m", native)
    for name in ("set_member_rows", "masked_topk", "masked_approx_topk",
                 "lloyd_step", "l2_topk", "lloyd_block"):
        if native.launches[name] <= 0:
            fail(f"cold phase: {name} was launched no time")
    launch_of["set_member_rows"] = native.launches["set_member_rows"]
    launch_of["lloyd_step"] = native.launches["lloyd_step"]
    launch_of["masked_approx_topk"] = native.launches["masked_approx_topk"]
    for tag in ("k=16", "k=1024", "k=1024 BxN mask", "k>N"):
        launch_of[f"masked_topk[{tag}]"] = native.launches["masked_topk"]
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    perf.update(cold_save_s=save_s, cold_saved_gb=saved_bytes / 1e9,
                cold_lazy_serve_ready_s=sidecar_s,
                cold_first_search_s=first_s,
                cold_first_search_rows_fetched=first_stats.get(
                    "rows_fetched_on_demand"),
                cold_materialize_s=materialize_s,
                cold_insert_2048_s=insert_s, cold_inserts_found=found,
                cold_ops_approx_recall_at_10=approx_recall,
                cold_migrate_s=migrate_s, cold_migrate_errors=errs,
                cold_eager_load_s=eager_s,
                cold_eager_prewarm_first_search_s=serve_s,
                cold_device_peak_gb=peak)
    print(f"cold: 2,048 inserts after the load {insert_s:.3f} s, "
          f"{found:.4f} at rank 1; ops over {n_rows} rows: masked_topk "
          f"exact, masked_approx_topk recall@10 {approx_recall:.4f}; "
          f"migrate_index 64 -> 128 lists {migrate_s:.3f} s, errors {errs}; "
          f"eager bf16 load {eager_s:.3f} s, prewarm + first search "
          f"{serve_s:.3f} s; live rows {n_live}; launches {counts}; device "
          f"peak {peak:.3f} GB above {base_mem / 1e9:.3f} GB ({card})",
          flush=True)
    del eg
    gc.collect()
    torch.cuda.empty_cache()


REPLACES = {  # the JAX function each kernel (entry) takes the place of
    "l2_topk": "fabstir_vectordb_tpu/index/fused.py:51",
    "l2_topk[candidates]": "fabstir_vectordb_tpu/index/hnsw.py:81",
    "l2_topk[bf16 candidates]": "fabstir_vectordb_tpu/index/hnsw.py:81",
    "approx_topk": "fabstir_vectordb_tpu/ops/topk.py:44",
    "rerank_f32[f32 rows]": "fabstir_vectordb_tpu/index/fused.py:114",
    "rerank_f32[f32 rows B=1]": "fabstir_vectordb_tpu/index/fused.py:114",
    "flat_search_rerank": "fabstir_vectordb_tpu/index/fused.py:106",
    "heuristic_kept": "fabstir_vectordb_tpu/index/hnsw.py:160",
    "pair_sq_l2": "fabstir_vectordb_tpu/index/hnsw.py:222",
    "lloyd_block": "fabstir_vectordb_tpu/ops/kmeans.py:112",
    "lloyd_block_fma": "fabstir_vectordb_tpu/ops/kmeans.py:112",
    "assign_clusters_fma": "fabstir_vectordb_tpu/ops/kmeans.py:70",
    "greedy_descent": "fabstir_vectordb_tpu/index/hnsw.py:249",
    "beam_search": "fabstir_vectordb_tpu/index/hnsw.py:312",
    "ivf_scan": "fabstir_vectordb_tpu/index/ivf.py:79",
    "l2_topk[bf16]": "fabstir_vectordb_tpu/index/fused.py:206",
    "seed_pick": "fabstir_vectordb_tpu/ops/kmeans.py:150",
    "seed_min_update": "fabstir_vectordb_tpu/ops/kmeans.py:130",
    "seed_counts": "fabstir_vectordb_tpu/ops/kmeans.py:140",
    "seed_min_update_fma": "fabstir_vectordb_tpu/ops/kmeans.py:130",
    "kmeans_pp": "fabstir_vectordb_tpu/ops/kmeans.py:33",
    "stage1_select": "fabstir_vectordb_tpu/index/fused.py:65",
    "project_rows": "fabstir_vectordb_tpu/index/fused.py:197",
    "project_queries": "fabstir_vectordb_tpu/index/fused.py:741",
    "rerank_f32": "fabstir_vectordb_tpu/index/fused.py:83",
    "merge_topk": "fabstir_vectordb_tpu/ops/topk.py:61",
    "synth_rows": "fabstir_vectordb_tpu/utils/synth.py:76",
    "assign_clusters": "fabstir_vectordb_tpu/ops/kmeans.py:70",
    "tile_step": "fabstir_vectordb_tpu/index/tiered.py:31",
    "l2_topk[cosine k=16]": "fabstir_vectordb_tpu/index/flat.py:30",
    "l2_topk[cosine k=1024]": "fabstir_vectordb_tpu/index/flat.py:30",
    "l2_topk[dot k=16]": "fabstir_vectordb_tpu/index/flat.py:30",
    "l2_topk[dot k=1024]": "fabstir_vectordb_tpu/index/flat.py:30",
    "l2_topk[bf16 cosine k=16]": "fabstir_vectordb_tpu/index/flat.py:30",
    "l2_topk[bf16 cosine k=1024]": "fabstir_vectordb_tpu/index/flat.py:30",
    "l2_topk[bf16 dot k=16]": "fabstir_vectordb_tpu/index/flat.py:30",
    "l2_topk[bf16 dot k=1024]": "fabstir_vectordb_tpu/index/flat.py:30",
    "hybrid_search": "fabstir_vectordb_tpu/index/fused.py:145",
    "chunked_topk": "fabstir_vectordb_tpu/ops/topk.py:73",
    "kmeans_pp_init": "fabstir_vectordb_tpu/ops/kmeans.py:33",
    "kmeans_train": "fabstir_vectordb_tpu/ops/kmeans.py:279",
    "quantize_u8": "fabstir_vectordb_tpu/ops/quantization.py:27",
    "dequantize_u8": "fabstir_vectordb_tpu/ops/quantization.py:39",
    "pq_train": "fabstir_vectordb_tpu/ops/quantization.py:59",
    "pq_encode": "fabstir_vectordb_tpu/ops/quantization.py:87",
    "pq_decode": "fabstir_vectordb_tpu/ops/quantization.py:106",
    "pq_adc_table": "fabstir_vectordb_tpu/ops/quantization.py:114",
    "pq_adc_distances": "fabstir_vectordb_tpu/ops/quantization.py:131",
    "shard_merge": "fabstir_vectordb_tpu/parallel/sharded.py:89",
    "shard_merge[ivf]": "fabstir_vectordb_tpu/parallel/sharded.py:252",
    "set_rows": "fabstir_vectordb_tpu/parallel/ingest.py:44",
    "lloyd_partial": "fabstir_vectordb_tpu/parallel/sharded.py:287",
    "lloyd_finish": "fabstir_vectordb_tpu/parallel/sharded.py:305",
    "ivf_scan[shard range]": "fabstir_vectordb_tpu/parallel/sharded.py:226",
    "sharded_flat_search": "fabstir_vectordb_tpu/parallel/sharded.py:40",
    "sharded_projected_search": "fabstir_vectordb_tpu/parallel/sharded.py:114",
    "sharded_ivf_search": "fabstir_vectordb_tpu/parallel/sharded.py:206",
    "sharded_lloyd_step": "fabstir_vectordb_tpu/parallel/sharded.py:280",
    "sharded_assign_clusters": "fabstir_vectordb_tpu/parallel/ingest.py:50",
    "sharded_hnsw_search": "fabstir_vectordb_tpu/parallel/sharded.py:423",
    "set_member_rows": "fabstir_vectordb_tpu/index/hnsw.py:137",
    "lloyd_step": "fabstir_vectordb_tpu/ops/kmeans.py:84",
    "masked_topk": "fabstir_vectordb_tpu/ops/topk.py:20",
    "masked_approx_topk": "fabstir_vectordb_tpu/ops/topk.py:44",
}
SOURCES = {
    "l2_topk": "fabstir_vectordb_tpu_torch/csrc/l2_topk.cu",
    "heuristic_kept": "fabstir_vectordb_tpu_torch/csrc/heuristic_kept.cu",
    "pair_sq_l2": "fabstir_vectordb_tpu_torch/csrc/pair_sq_l2.cu",
    "lloyd_block": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "lloyd_block_fma": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "assign_clusters_fma": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "greedy_descent": "fabstir_vectordb_tpu_torch/csrc/greedy_descent.cu",
    "beam_search": "fabstir_vectordb_tpu_torch/csrc/beam_search.cu",
    "ivf_scan": "fabstir_vectordb_tpu_torch/csrc/ivf_scan.cu",
    "seed_pick": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "seed_min_update": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "seed_counts": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "seed_min_update_fma": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "kmeans_pp": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "stage1_select": "fabstir_vectordb_tpu_torch/csrc/stage1_select.cu",
    "project_rows": "fabstir_vectordb_tpu_torch/csrc/project_rows.cu",
    "project_queries": "fabstir_vectordb_tpu_torch/csrc/project_rows.cu",
    "rerank_f32": "fabstir_vectordb_tpu_torch/csrc/rerank_f32.cu",
    "merge_topk": "fabstir_vectordb_tpu_torch/csrc/merge_topk.cu",
    "synth_rows": "fabstir_vectordb_tpu_torch/csrc/synth.cu",
    "assign_clusters": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "tile_step": "fabstir_vectordb_tpu_torch/csrc/l2_topk.cu",
    "approx_topk": "fabstir_vectordb_tpu_torch/csrc/approx_topk.cu",
    # compositions of kernels, in the module that chains them: K1 then
    # K2; K10, K11 then K12
    "flat_search_rerank": "fabstir_vectordb_tpu_torch/index/fused.py",
    "hybrid_search": "fabstir_vectordb_tpu_torch/index/fused.py",
    # the fused chunk step, or past k = 256 the filtered select
    "chunked_topk": "fabstir_vectordb_tpu_torch/csrc/merge_topk.cu",
    # K7's k-means++ kernel (one launch) and the rows' gather
    "kmeans_pp_init": "fabstir_vectordb_tpu_torch/ops/kmeans.py",
    # k-means++ then K6's blocks; pq_train seeds every subspace in one
    # launch, then runs Lloyd on each
    "kmeans_train": "fabstir_vectordb_tpu_torch/ops/kmeans.py",
    "pq_train": "fabstir_vectordb_tpu_torch/ops/quantization.py",
    "quantize_u8": "fabstir_vectordb_tpu_torch/csrc/quantize.cu",
    "dequantize_u8": "fabstir_vectordb_tpu_torch/csrc/quantize.cu",
    "pq_encode": "fabstir_vectordb_tpu_torch/csrc/pq.cu",
    "pq_decode": "fabstir_vectordb_tpu_torch/csrc/pq.cu",
    "pq_adc_table": "fabstir_vectordb_tpu_torch/csrc/pq.cu",
    "pq_adc_distances": "fabstir_vectordb_tpu_torch/csrc/pq.cu",
    "shard_merge": "fabstir_vectordb_tpu_torch/csrc/shard_merge.cu",
    "set_rows": "fabstir_vectordb_tpu_torch/csrc/shard_merge.cu",
    "lloyd_partial": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "lloyd_finish": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    # K15's compositions, in the module that chains their kernels
    "sharded_flat_search": "fabstir_vectordb_tpu_torch/parallel/sharded.py",
    "sharded_projected_search":
        "fabstir_vectordb_tpu_torch/parallel/sharded.py",
    "sharded_ivf_search": "fabstir_vectordb_tpu_torch/parallel/sharded.py",
    "sharded_lloyd_step": "fabstir_vectordb_tpu_torch/parallel/sharded.py",
    "sharded_assign_clusters": "fabstir_vectordb_tpu_torch/parallel/ingest.py",
    "sharded_hnsw_search": "fabstir_vectordb_tpu_torch/parallel/sharded.py",
    # the set-rows kernel K15's sharded build runs, as the pipelined
    # build's member scatter
    "set_member_rows": "fabstir_vectordb_tpu_torch/csrc/shard_merge.cu",
    "lloyd_step": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "masked_topk": "fabstir_vectordb_tpu_torch/csrc/merge_topk.cu",
    "masked_approx_topk": "fabstir_vectordb_tpu_torch/csrc/approx_topk.cu",
}

# the tensor-core pass (an entry whose tile_pass is not "fma": K1 and K9 on
# a bf16 mirror, K1 / K3 on f32 rows and on bf16 rows with an f32 query),
# built into csrc/l2_topk.cu and csrc/approx_topk.cu
TILE_SOURCE = "fabstir_vectordb_tpu_torch/csrc/bf16_tile.cuh"
# K14's stage 1 on that pass: its filter route, launched through
# csrc/l2_topk.cu (the dump route of csrc/stage1_select.cu is in
# ROUTE_CHECKS)
FILTER_SOURCE = "fabstir_vectordb_tpu_torch/csrc/tile_filter.cuh"


def source_of(base: str, r: dict) -> str:
    """The source of an entry's kernel: its own file, or for K1 and K9 off
    the FMA pass (tile_pass) the tensor-core pass's header (K14's stage 1
    its filter route's); K4's routes are both in csrc/heuristic_kept.cu."""
    if base == "heuristic_kept" or r.get("tile_pass", "fma") == "fma":
        return SOURCES[base]
    return FILTER_SOURCE if base == "stage1_select" else TILE_SOURCE


# what an entry held to its plain version up to ties reports beside its
# max_abs_err: the first k-means++ pick at a key tie, the rows or codes
# that differ at ties
TIE_KEYS = ("first_tie_pick", "rows_differing_at_ties",
            "codes_differing_at_ties", "overlap")
# measured beside ms: K12's stages (from the profiler), a call's card time
# (device_us) and host time, and torch.topk's beside the merge's; K1's and
# K9's pass (tile_pass: ops.topk.tile_route's name), K4's
# (index.hnsw.heuristic_route's), the bound on f32 FMA beside a
# tensor-core route's (bound_fma_ms) and a bf16 torch.matmul of the same
# product (gemm_ms)
DETAIL_KEYS = ("stage_us", "host_us", "library_host_us", "device_us",
               "seeding_ms", "lloyd_ms", "rows_moved",
               "last_centroids_apart", "parted_at", "parting_gap",
               "rows_off", "off_gap",
               "steps_max", "longest", "warps_a_query",
               "library_device_us", "tile_pass", "gemm_ms", "bound_fma_ms",
               "stage1_select_fma_launches",
               "stage1_select_overflow_launches", "launches_one_call")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "pruned",
                                        "reduced", "flat1m", "engines",
                                        "quant", "parallel", "cold",
                                        "scale"),
                    default="all")
    ap.add_argument("--profile", action="store_true",
                    help="cProfile the main path into --out (its timings "
                         "then carry the profiler's overhead)")
    ap.add_argument("--trace", action="store_true",
                    help="torch.profiler over 64 single and 4 batched "
                         "searches of each regime: device busy share, ops "
                         "by device time")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for --profile and --trace reports")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    try:
        from fabstir_vectordb_tpu_torch.index import hnsw as hn
        from fabstir_vectordb_tpu_torch.ops import kmeans as km
        from fabstir_vectordb_tpu_torch.ops import topk as tp
        from fabstir_vectordb_tpu_torch.utils import native
        from fabstir_vectordb_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    t_start = time.perf_counter()
    card = card_line()
    dev = resolve_device(None)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)
    nv = subprocess.run([native.nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60)
    print("nvcc: " + nv.stdout.strip().splitlines()[-1], flush=True)
    build_s = native.build_all()
    print(f"build: {len(native.SOURCES)} kernels in {build_s:.1f} s", flush=True)
    for name, log in native.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    results: dict = {}
    if args.phase not in ("pruned", "flat1m", "engines", "quant", "parallel",
                          "scale"):  # "cold" checks B1-B4 here first
        kernels_phase(torch, tp, hn, km, dev, results)
    counts: dict = {}
    perf: dict = {}
    launch_of: dict = {}
    if args.phase == "all":
        prof = {} if args.profile else None
        main_path(torch, native, card, counts, perf, prof=prof,
                  trace=args.trace, out_dir=args.out)
        for name, p in (prof or {}).items():
            import pstats

            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, f"profile_{name}.txt")
            with open(path, "w") as f:
                for key in ("tottime", "cumulative"):
                    pstats.Stats(p, stream=f).sort_stats(key).print_stats(40)
            print(f"profile: {path}", flush=True)
    if args.phase in ("all", "pruned", "reduced", "flat1m", "engines",
                      "parallel", "cold"):
        t = time.perf_counter()
        ctx = build_1m(torch, native, card, perf, launch_of)
        k7_checks(torch, ctx, results)
        for name in ("seed_pick", "seed_min_update_fma", "seed_min_update",
                     "seed_counts"):
            print_kernel(name, results[name], launch_of[name])
        print(f"1M build: {time.perf_counter() - t:.1f} s", flush=True)
        for name, phase in (("pruned", pruned_phase),
                            ("reduced", reduced_phase),
                            ("flat1m", flat1m_phase),
                            ("engines", engines_phase)):
            if args.phase not in ("all", name):
                continue
            t = time.perf_counter()
            phase(torch, native, card, perf, results, launch_of, ctx,
                  trace=args.trace, out_dir=args.out)
            print(f"{name} phase: {time.perf_counter() - t:.1f} s",
                  flush=True)
        if args.phase == "all":  # on the same rows, with the index held
            t = time.perf_counter()
            quant_phase(torch, native, card, perf, results, launch_of,
                        ctx["x"])
            print(f"quant phase: {time.perf_counter() - t:.1f} s",
                  flush=True)
        if args.phase in ("all", "parallel"):  # the last on the 1M state
            t = time.perf_counter()
            parallel_phase(torch, native, card, perf, results, launch_of, ctx)
            print(f"parallel phase: {time.perf_counter() - t:.1f} s",
                  flush=True)
        if args.phase in ("all", "cold"):  # the 1M index saved and loaded
            t = time.perf_counter()
            cold_phase(torch, native, card, perf, results, launch_of, ctx)
            print(f"cold phase: {time.perf_counter() - t:.1f} s", flush=True)
        del ctx  # the 1M state goes before the 10M tier is built
    if args.phase == "quant":
        t = time.perf_counter()
        quant_phase(torch, native, card, perf, results, launch_of)
        print(f"quant phase: {time.perf_counter() - t:.1f} s", flush=True)
    if args.phase in ("all", "scale"):
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        scale_phase(torch, native, card, perf, results, launch_of,
                    trace=args.trace, out_dir=args.out)
        print(f"scale phase: {time.perf_counter() - t:.1f} s", flush=True)
    kernels = []
    for key, r in results.items():
        base = key.split("[")[0]
        launches = launch_of.get(key, counts.get(key, counts.get(base, 0)))
        kernels.append({
            "name": key, "route": "cuda",
            "source": source_of(base, r),
            "replaces": REPLACES.get(key, REPLACES[base]),
            "launches": int(launches),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            **{k: r[k] for k in TIE_KEYS + DETAIL_KEYS if k in r},
        })
    if perf:
        print("main_path " + json.dumps(perf, default=float), flush=True)
    reads = {key: r["modelled_reads"] for key, r in results.items()
             if "modelled_reads" in r}
    if reads:
        print("k12_reads modelled from the probes (list rows x query "
              "groups; not counted on the card) " + json.dumps(reads),
              flush=True)
    if ROUTE_CHECKS:
        print("route_checks " + json.dumps(ROUTE_CHECKS), flush=True)
    if SHAPE_LAUNCHES:
        print("launches_by_shape (K2, K6, K7, K10, K11) "
              + json.dumps(SHAPE_LAUNCHES),
              flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s; card: {card}",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

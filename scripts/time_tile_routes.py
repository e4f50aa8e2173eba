#!/usr/bin/env python3
"""Time K14's stage 1, K1 / K3 on f32 rows (and on bf16 rows with an f32
query), K4, K9 on f32 rows, K11, K6, K2, K10 and K7 on one NVIDIA GPU,
beside yardsticks that the port never calls.

    python scripts/time_tile_routes.py [--root DIR] [--out DIR] [--iters N]
                                       [--only stage1|f32|k4|k9f32|k9bf16|
                                               k11|k6|k2|k10|k7|k16]
                                       [--profile]
                                       [--split fma|tf32x3|stage1|k4|k9f32|
                                                k11|k6]

``--root`` imports ``fabstir_vectordb_tpu_torch`` from another checkout (an
older tree unpacked under ``build/``, e.g. ``git archive HEAD~``), so two
versions can be timed in one call, in turns (parent, change, change,
parent); its kernels build into that tree's own ``build/``.

Stage 1 (``index.fused.stage1_select``): a seeded 10,485,760 x 192 bf16
mirror (its first 1,048,576 rows for the 1M shapes) with the bf16 rows'
norms, 90% of the rows in the mask; 1M at B = 1 and 128, ov_k = 1,024;
10M at B = 1, 32 and 128, ov_k = 2,048, under the 2 GiB transient that the
reduced-rank dispatch passes at bench.py's 10M operating point. Yardstick:
a bf16 ``torch.matmul`` of [B, 192] x [192, N].

f32 rows (``ops.topk.l2_topk``): K3's link candidates (131,072 x 384, B =
1,024, k = 200) and K1's search (B = 128, k = 16) there; the other callers
of the f32 pass: K1 by cosine and dot over 1,048,576 x 384 at k = 16 and
1,024, K15's flat shard search (B = 128, k = 10, 1M), K1 at the
filtered searches' large k (B = 4, k = 1,024 and 16,384, 1M: the filter
route), K8's tile step (B =
32, 699,392 rows, k = 10, norms in the kernel, a row base); and bf16 rows
with an f32 query: K3 on a bf16 mirror (1M, B = 1,024, k = 200) and the
calibration oracle's block (524,288 rows, B = 128, k = 11, norms in the
kernel). Yardstick: an f32 ``torch.matmul`` of the same product with TF32
off (and a bf16 one for the bf16 rows).

K4 (``index.hnsw.heuristic_kept``, ``--only k4``): the candidate pools of
1,024 queries over 131,072 x 384 seeded f32 rows, each query's 128
nearest rows by an f32 ``torch.matmul`` (TF32 off) and ``torch.topk``: the
link pool (C = 128, m = 32), the reverse prune (C = 64, the last 8 padded
with (-1, +inf)), both on the rows in bf16, the first 32 candidates (an
ef_construction of 32), and the link pool on rows 4 bytes off a 16-byte
boundary (the FMA route in a tree that has another). Each is held to its
plain version: the kept flags equal but where the first flip of a query
sits at a near-tie of the plain scan (1e-5 of the query distance on f32
rows; of twice the largest squared norm on bf16 rows).

K9 on f32 rows (``ops.topk.approx_topk``, ``--only k9f32``): a pool of 128
over 1,048,576 x 384 seeded f32 rows, 99% of them in the mask, at B = 1
and 128 (2,477 bins); ``--only k9bf16``: the same rows in bf16, the query
rounded (the turbo pool's route); each held to its plain version: the
pools share >= 0.99 of their rows on average, the shared rows' distances
within 1e-5 of the largest norms.

K11 (``index.hnsw.beam_search``, ``--only k11``): a seeded layered graph
over every 8th row of 1,048,576 x 384 clustered f32 rows (k11_graph: exact
neighbours, 32 at layer 0, 16 above), starts by K10's descent; serve at B
= 1 and 128 (ef 64, W 4, +- a filter of half the rows), on f32 and bf16
rows; the layer-0 link (B = 1,024, ef 200, W 1) and one upper layer (the
queries below it inactive) on each. Each held to its plain version
(overlap >= 0.99, no filtered-out row), with the plain version's steps
(all queries, and the longest query's chain) beside a latency bound:
that chain times one dependent global read, which a one-thread pointer
chase over 1 GiB measures here (and over 8 MiB, from L2). Device
microseconds by kernel always (torch.profiler).

K6 (``ops.kmeans``, ``--only k6``): the 10M tier's assignment block
(1,048,576 x 384, C = 256), kmeans_train's Lloyd block (65,536, 5 steps),
the sharded partial (1,000,000 rows) and the sharded assignment's four
shard calls, PQ's block (D = 48) and B2's step, each against its plain
version (assignments >= 99.9% equal; the centroids' and errors' gaps
printed) and its route.

K7 (``ops.kmeans`` / ``ops.quantization``, ``--only k7``): k-means++ at
kmeans_train's shape (65,536 x 384 of bench.py's mixture, C = 256),
pq_train's seeding at M = 8 and 48 (K = 256: the tree's batched seeding,
or one kmeans_pp_init a subspace where the tree has none), kmeans_train
whole, and kmeans||'s table update (10,000 x 384, l = 409) and counts
(2,046 candidates); each shape's device microseconds by kernel
(torch.profiler), by CUDA events behind a sleep, and the host
microseconds a call, beside its bounds: bytes, three TF32 products, and
for k-means++ C grid barriers, whose nanoseconds a cooperative launch of
csrc/grid_barrier.cuh's barrier across one block an SM measures here.
First, kmeans||'s pick (``seed_pick``) at N = 10,000 (l = 409 weighted,
l = 1 unweighted), the sharded trainer's N = 10,240 and IVF training's
16,384 padded rows (l = 409): the same
figures, torch.equal to the plain version, and beside the bytes' bound
the back-to-back ms of an empty kernel through the same ctypes path
(where the tree has csrc/kmeans_seed.cu's ``fvdb_empty_launch``).
Where the tree has them, each is held to its plain version (k-means++
pick for pick up to key ties, the table within 1e-6 of the largest
|x|^2, the counts with at most 0.1% of the rows moved).

K16 (``ops.quantization``, ``--only k16``): the quant phase's rows
(bench.py's 1M tier, 1,000,000 x 384: 1,024 centers, noise 0.35, seed 0),
a PQ codebook trained on its first 65,536 at M = 8 and 48 (K = 256), the
encode of all 1M rows, the ADC scan of 128 queries drawn as bench.py
draws them ([128, 1M]) and the decode of the codes; each shape's ms by
CUDA events, device microseconds by kernel (torch.profiler) and launches,
the encode's codes against its plain version (differing only at float64
ties within 1e-6), the scan against its plain version bit for bit, the
decode torch.equal to its plain version beside one advanced-indexing
gather (``cents[sub, idx]``, the indices int64 and clamped beforehand);
where the tree has two encode routes, the FMA route at the same shapes (a
direct call).

K2 (``index.fused.rerank_f32``, ``--only k2``): seeded bf16 rows
(1,048,576 x 384, and 10,485,760 x 384 for the 10M tier's OV = 2,048) and
the same 1M rows in f32, pools of random rows: bf16 OV = 1,024 m = 64, the
10M tier's OV = 2,048 m = 64 and f32 rows OV = 128 m = 16, each at B =
128 and B = 1, and a filtered search's pool of 16,384 at m = 512 (the
radix route), each held to its plain version. K10
(``index.hnsw.greedy_descent``, ``--only k10``): k11_graph's upper
layers, f32 and bf16 rows, B = 128, 1 and 1,024, each held to its plain
version (99% of walks equal), with its longest query's hop attempts
beside a latency bound (those attempts x one dependent read from L2, and
from HBM, by the pointer chase). Both give each shape's device
microseconds by kernel (torch.profiler), its device microseconds by CUDA
events behind a sleep, and the wrapper's host microseconds a call.

``--profile`` adds each shape's device microseconds by kernel, from
torch.profiler's kernel records of one call (K4: the mean of 20). Each
result is held to its plain version on the same inputs (sorted
distances within 2e-5 of the largest norms, rows equal but at ties; 1e-5
for cosine), 10M stage 1 in slices of 32 queries. Times are CUDA events
over back-to-back calls after a warm-up. Prints one JSON line and writes
it to ``--out``/time_tile_routes_<tree>.json.

``--split ROUTE`` builds patched copies of the tree's csrc/l2_topk.cu into
build/split/ROUTE/<variant>/ and times K3 and K1 f32 on each, for the
pass that f32 rows take in that tree: "fma" (l2_tile.cuh, the parent of
the split routes): "as_is"; "no_insert", every distance offered to its
list (the warp's ballot) and none inserted; "no_offer", the products and
the distances through shared memory with no offer; "tf32x3"
(bf16_tile.cuh): "as_is"; "no_offer", no distance offered to a list;
"no_mma", no tensor-core product (the rows still read and split);
"x_from_l2", every block reading the same eight tiles (L2 hits); and
"stage1" (the FILTER mode as csrc/l2_topk.cu builds it, stage 1 at 10M
B = 1 and 128, 1M B = 128): "as_is"; "no_epilogue", no distance kept
(the sample's slots and the survivors left as they lie); "no_flush", survivors staged but never
written out; "compare_only", the bar's test alone (its passes counted,
none staged); "no_slots", the sample's slots not written; "no_mma", no
product; "x_from_l2", every block reading the same eight tiles (L2
hits); "k9f32" (bf16_tile.cuh's BINS mode on the TF32 route, built into
csrc/approx_topk.cu, K9 on f32 rows at B = 1 and 128): "as_is";
"cvt_round", the TF32 rounding by cvt.rna.tf32.f32 (the tree's two
integer operations give the same bits); "two_sets", the next step's
fragments read during this step's products
at every width (two register sets; the tree reads them before the
products at 32 queries a block, as under the lists); "k4" (K4's
tensor-core route, csrc/heuristic_kept.cu, at every --only k4 shape but
the FMA route's): "as_is"; "one_product", the f32 rows' big products
alone; "bf16_three_wg", bf16 rows past 64 candidates on three warpgroups
(one block each, one block an SM) for one (three blocks' sums, three
blocks an SM); "k11" (csrc/beam_search.cu at K11's f32 shapes: a phase
done twice, so the walk is the same and the added time is the phase's:
the parent kernel's "member_twice" (each candidate's serial pool scan),
"rank_twice" (the O(nv) rank), "gather_twice" (the rows' distances);
this tree's "gather_twice", "scan_from_zero" (the
parents sought from position 0, not from the first unexpanded one),
"regs_255" (one block an SM in the launch bounds: 255 registers, not
128), "one_warp" (one warp a query) and "stats" (the clock64 cycles of each
phase of a step in one active query's block, printed a call); a variant
whose text a tree does not hold is skipped); "k6" (csrc/lloyd.cu's
tensor-core route at the 1M assignment and partial and the Lloyd
block): "as_is"; "no_sums", no row added into the sums (the N x D
atomics); "scalar_atomics", the sums four 4-byte atomics a 16-byte
piece; "no_mma", no product; "x_from_l2", every block reading the first
128 rows (L2 hits).
The results are wrong
on purpose, but for "k9f32" and "k11", whose variants compute the same;
only the time is read. Each variant's ptxas report (registers, spills, serialized
products) is printed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N1, N10, R = 1_048_576, 10_485_760, 192
NF, D = 131_072, 384
# patched copies of a tree's headers, by the pass that they cut up
# (file, text, its replacement): K1 / K3 on f32 rows on the FMA pass or on
# the TF32 route, and K14's stage 1 on the FILTER route
TILE_ROWS = ("                    (g % KS) * SD, tile_row0(g / KS), "
             "full + slot);")
X_FROM_L2 = ("bf16_tile.cuh", TILE_ROWS,
             "                    (g % KS) * SD, ((g / KS) % 8) * TC_ROWS, "
             "full + slot);")
# K4's small products on wgmma, chained onto each k8 big product
K4_SMALL = (
    "            wgmma_tf32_ss64(pb[jj], da_s + 2 * j, db + 2 * j, 1);\n"
    "            wgmma_tf32_ss64(pb[jj], da + 2 * j, db_s + 2 * j, 1);\n")
SPLITS = {
    "fma": {  # l2_tile.cuh's FMA pass (the parent of the split routes)
        "as_is": [],
        "no_insert": [("common.cuh", "    while (bits) {",
                       "    while (bits && k < 0) {")],
        "no_offer": [("l2_tile.cuh",
                      "          list.offer(isfinite(dist), dist, r0 + rl);",
                      "          if (k < 0) list.offer(isfinite(dist), dist, "
                      "r0 + rl);")],
    },
    "tf32x3": {  # bf16_tile.cuh's TF32 route
        "as_is": [],
        "no_offer": [("bf16_tile.cuh",
                      "    } else {\n      // the bars all slices share",
                      "    } else if (k < 0) {\n      // the bars all slices "
                      "share")],
        "no_mma": [("bf16_tile.cuh",
                    "        for (int j = 0; j < 4; ++j) {\n"
                    "          WgmmaTF32<QW>::mma(ps",
                    "        for (int j = 0; j < 4 * (k < 0); ++j) {\n"
                    "          WgmmaTF32<QW>::mma(ps")],
        "x_from_l2": [X_FROM_L2],
    },
    "stage1": {  # bf16_tile.cuh's FILTER mode, built into csrc/l2_topk.cu
        "as_is": [],
        "no_epilogue": [("bf16_tile.cuh",
                         "      if (fa.bar == nullptr) {  // a slot a row",
                         "      if (split > 0) {\n      } else if "
                         "(fa.bar == nullptr) {  // a slot a row")],
        "no_flush": [("bf16_tile.cuh",
                      "          const int p = atomicAdd(scnt + col, 1);",
                      "          const int p = atomicAdd(scnt + col, 1) & 15;"),
                     ("bf16_tile.cuh",
                      "            if (n >= need) {  // uniform across the "
                      "warp",
                      "            if (n >= need && split < 0) {")],
        "no_mma": [("bf16_tile.cuh",
                    "          Wgmma<QW>::mma(part, da + 2 * j, db + 2 * j, j);",
                    "          if (da == 0) "
                    "Wgmma<QW>::mma(part, da + 2 * j, db + 2 * j, j);")],
        "compare_only": [  # the bar's test, its count kept, no staging
            ("bf16_tile.cuh",
             "          if (!(acc[i] < INFINITY && acc[i] <= qbar[col])) "
             "continue;",
             "          if (!(acc[i] < INFINITY && acc[i] <= qbar[col])) "
             "continue;\n          if (split > 0) { ++npass; continue; }"),
            ("bf16_tile.cuh",
             "  int g = 0;  // the block's step, as the producer counts them",
             "  int npass = 0;\n"
             "  int g = 0;  // the block's step, as the producer counts them"),
            ("bf16_tile.cuh",
             "  if constexpr (MODE == SEL_BINS) {\n#pragma unroll\n"
             "    for (int i = 0; i < M; ++i) {\n"
             "      if (!(run[i] < INFINITY)) continue;",
             "  if (npass == 123456789) fa.cnt[0] = npass;\n"
             "  if constexpr (MODE == SEL_BINS) {\n#pragma unroll\n"
             "    for (int i = 0; i < M; ++i) {\n"
             "      if (!(run[i] < INFINITY)) continue;")],
        "no_slots": [("bf16_tile.cuh",
                      "            fa.surv[(size_t)(q0 + col) * fa.cap + v] =",
                      "            if (split < 0) "
                      "fa.surv[(size_t)(q0 + col) * fa.cap + v] =")],
        "x_from_l2": [X_FROM_L2],
    },
    "k4": {  # csrc/heuristic_kept.cu's tensor-core route
        "as_is": [],
        "one_product": [("heuristic_kept.cu", K4_SMALL, "")],
        "bf16_three_wg": [("heuristic_kept.cu",
                           "  return sizeof(T) == 4 && R == 128 ? 3 : 1;",
                           "  return R == 128 ? 3 : 1;")],
    },
    "k9f32": {  # bf16_tile.cuh's BINS mode on the TF32 route
        "as_is": [],
        "cvt_round": [("wgmma.cuh", "      \"mov.b32 t, %1;\\n\"\n"
                       "      \"add.u32 t, t, 0x1000;\\n\"",
                       "      \"cvt.rna.tf32.f32 t, %1;\\n\"")],
        "two_sets": [("bf16_tile.cuh",
                      "  return mode == SEL_LISTS || (mode == SEL_BINS && "
                      "qw > 8);",
                      "  return mode == SEL_LISTS;")],
    },
}
# the source each --split pass is built into
SPLITS["k11"] = {  # csrc/beam_search.cu: a phase twice, the walk unchanged
    "as_is": [],
    # the parent kernel (one 256-thread block a query)
    "member_twice": [("beam_search.cu",
                      "    for (int p = 0; ok && p < pool_n; ++p) ok = "
                      "L.pid[p] != id;",
                      "    for (int p = 0; ok && p < pool_n; ++p) ok = "
                      "L.pid[p] != id;\n    for (int p = 0; ok && p < "
                      "pool_n; ++p) ok = L.pid[p] != id;")],
    "rank_twice": [("beam_search.cu",
                    "      for (int j = 0; j < nv; ++j) {\n"
                    "        const float dj = v_d[j];\n"
                    "        rank += (dj < di) || (dj == di && j < t);",
                    "      for (int j = 0; j < 2 * nv; ++j) {\n"
                    "        const float dj = v_d[j % nv];\n"
                    "        rank += j < nv && ((dj < di) || (dj == di && "
                    "j < t));")],
    "gather_twice": [("beam_search.cu",
                      "    for (int i0 = w * 4; i0 < nv; i0 += (NT / 32) * 4) {",
                      "    for (int rep = 0; rep < 2; ++rep)\n"
                      "    for (int i0 = w * 4; i0 < nv; i0 += (NT / 32) * 4) {"),
                     ("beam_search.cu",
                      "    for (int base = w * BS_G; base < nv; base += NW * "
                      "BS_G) {",
                      "    for (int rep = 0; rep < 2; ++rep)\n"
                      "    for (int base = w * BS_G; base < nv; base += NW * "
                      "BS_G) {")],
    # this tree's kernel (a block of 1-8 warps a query)
    "scan_from_zero": [("beam_search.cu",
                        "        for (int p0 = first; p0 < pool_n && nsel < "
                        "W; p0 += 32) {",
                        "        for (int p0 = 0 * first; p0 < pool_n && nsel "
                        "< W; p0 += 32) {")],
    "stats": [  # clock64 of each phase in one active block's thread 0
        ("beam_search.cu", "// KC: 32s of candidates a lane holds",
         "__device__ long long fvdb_phase_dev[8];\n"
         "// KC: 32s of candidates a lane holds"),
        ("beam_search.cu",
         "  int pool_n = 0, res_n = 0, first = 0, filled = 0;",
         "  int pool_n = 0, res_n = 0, first = 0, filled = 0;\n"
         "  long long _ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};"),
        ("beam_search.cu", "    const bool from_start = s0 < s_eff;",
         "    const long long _ts = clock64();\n"
         "    const bool from_start = s0 < s_eff;"),
        ("beam_search.cu", "    if (s_ctl[0]) break;\n",
         "    if (s_ctl[0]) break;\n    _ph[0] += clock64() - _ts;\n"
         "    long long _tp = clock64();\n"),
        ("beam_search.cu",
         "    for (int i = t; i < nsel; i += NTH) L.pexp[s_sel[i]] = 1;\n"
         "    __syncthreads();",
         "    for (int i = t; i < nsel; i += NTH) L.pexp[s_sel[i]] = 1;\n"
         "    __syncthreads();\n    _ph[2] += clock64() - _tp; _tp = "
         "clock64();"),
        ("beam_search.cu",
         "    if (from_start) s0 += NC;\n    __syncthreads();\n  }",
         "    _ph[7] += clock64() - _tp; _tp = clock64();\n"
         "    if (from_start) s0 += NC;\n    __syncthreads();\n"
         "    _ph[5] += clock64() - _tp; _ph[4] += 1; _ph[6] += nv;\n  }"),
        ("beam_search.cu",
         "    od[j] = INFINITY;\n    oi[j] = -1;\n  }\n}",
         "    od[j] = INFINITY;\n    oi[j] = -1;\n  }\n"
         "  if (t == 0 && b == (gridDim.x > 2 ? 2 : 0))\n"
         "    for (int i = 0; i < 8; ++i) fvdb_phase_dev[i] = _ph[i];\n}"),
        ("beam_search.cu",
         "// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask [N] (uint8); adj",
         "FVDB_EXPORT int fvdb_beam_phase_cycles(long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, fvdb::fvdb_phase_dev,\n"
         "                                   8 * sizeof(long long));\n}\n"
         "// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask [N] (uint8); adj"),
    ],
    "regs_255": [("beam_search.cu",
                  "__global__ void __launch_bounds__(BS_MAX_WARPS * 32, 2) "
                  "beam_search_kernel(",
                  "__global__ void __launch_bounds__(BS_MAX_WARPS * 32, 1) "
                  "beam_search_kernel(")],
    "one_warp": [("beam_search.cu",
                  "    kernel<<<B, 32 * warps, smem, stream>>>(",
                  "    kernel<<<B, 32, smem, stream>>>(")],
}
SPLITS["k6"] = {  # csrc/lloyd.cu's tensor-core route
    "as_is": [],
    "no_sums": [("lloyd.cu",
                 "        if (vec) {\n"
                 "          atomicAdd(reinterpret_cast<float4*>(sr + d), v);\n"
                 "        } else {",
                 "        if (c < 0) {\n"
                 "          atomicAdd(reinterpret_cast<float4*>(sr + d), v);\n"
                 "        } else if (c < 0) {")],
    "scalar_atomics": [("lloyd.cu",
                        "  const bool vec = (reinterpret_cast<uintptr_t>(sums) "
                        "& 15) == 0;",
                        "  const bool vec = false;")],
    "no_mma": [("lloyd.cu",
                "        WgmmaTF32<128>::mma(pb, ab[j], db + 2 * j, 0);\n"
                "        WgmmaTF32<128>::mma(pb, as[j], db + 2 * j, 1);\n"
                "        WgmmaTF32<128>::mma(pb, ab[j], ds + 2 * j, 1);",
                "        if (N < 0) {\n"
                "        WgmmaTF32<128>::mma(pb, ab[j], db + 2 * j, 0);\n"
                "        WgmmaTF32<128>::mma(pb, as[j], db + 2 * j, 1);\n"
                "        WgmmaTF32<128>::mma(pb, ab[j], ds + 2 * j, 1);\n"
                "        }")],
    "x_from_l2": [("lloyd.cu", "        tma_load_2d(dst, &tmx, k0, n0, full "
                   "+ slot);", "        tma_load_2d(dst, &tmx, k0, 0, full "
                   "+ slot);")],
}
# the source each --split pass is built into
SPLIT_SOURCE = {"fma": "l2_topk", "tf32x3": "l2_topk", "stage1": "l2_topk",
                "k4": "heuristic_kept", "k9f32": "approx_topk",
                "k11": "beam_search", "k6": "lloyd"}
# what a ptxas report line says that is worth printing
PTXAS_WORDS = ("registers", "spill", "serializ")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
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


def kernel_us(torch, fn, calls: int = 1) -> dict:
    """Device microseconds by kernel name of a call (torch.profiler's
    kernel records, the mean over ``calls`` calls), the longest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict = {}
    for _ in range(3):  # a window whose kernel records came back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("<")[0].split("(")[0][:60]
                out[name] = out.get(name, 0.0) + e.device_time / calls
        if out:
            break
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def queued_us(torch, fn, calls: int = 20) -> float:
    """Device microseconds a call of ``fn`` takes back to back: CUDA
    events around ``calls`` calls queued behind a sleep of the card, so no
    host gap falls between them (a check on the profiler's sum)."""
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


def host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to return (its launches
    queued, the card not waited for), over ``calls`` back-to-back calls
    behind a sleep of the card, so no launch waits for a full queue."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e6


def topk_err(vk, rk, vp, rp, tol: float, what: str) -> tuple:
    """(max |distance difference| after sorting by (distance, row),
    queries whose rows differ); a row in one list only must tie the k-th
    within tol."""
    vk, rk, vp, rp = (t.cpu().numpy() for t in (vk, rk, vp, rp))
    ok, op = np.lexsort((rk, vk)), np.lexsort((rp, vp))
    vk, rk = np.take_along_axis(vk, ok, 1), np.take_along_axis(rk, ok, 1)
    vp, rp = np.take_along_axis(vp, op, 1), np.take_along_axis(rp, op, 1)
    fin = np.isfinite(vp)
    if not (np.isfinite(vk) == fin).all():
        raise SystemExit(f"{what}: padding differs from the plain version")
    err = float(np.abs(np.where(fin, vk - vp, 0.0)).max())
    if err > tol:
        raise SystemExit(f"{what}: max_abs_err {err} > {tol}")
    differ = 0
    for i in np.nonzero((rk != rp).any(1))[0]:
        differ += 1
        kth = vp[i][fin[i]].max()
        for r in set(rk[i][rk[i] >= 0]) ^ set(rp[i][rp[i] >= 0]):
            d = vp[i][rp[i] == r] if r in set(rp[i]) else vk[i][rk[i] == r]
            if abs(float(d[0]) - kth) > tol:
                raise SystemExit(f"{what}: query {i} row {r} off a tie")
    return err, differ


def stage1(torch, fu, res, it, prof=False) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    xp = torch.empty((N10, R), dtype=torch.bfloat16, device=dev)
    for lo in range(0, N10, 1 << 21):  # in blocks: the f32 draw is 8 GB
        hi = min(N10, lo + (1 << 21))
        xp[lo:hi] = torch.randn(hi - lo, R, device=dev, generator=g)
    xp_sq = (xp.float() ** 2).sum(1)
    mask = torch.rand(N10, device=dev, generator=g) < 0.9
    qp = torch.randn(128, R, device=dev, generator=g)
    budget = 2 << 30
    for n, b, ov in ((N1, 1, 1024), (N1, 128, 1024), (N10, 1, 2048),
                     (N10, 32, 2048), (N10, 128, 2048)):
        x, xs, m, q = xp[:n], xp_sq[:n], mask[:n], qp[:b].contiguous()

        def run(x=x, xs=xs, m=m, q=q, ov=ov):
            return fu.stage1_select(x, xs, m, q, ov, budget)

        vk, rk = run()
        tol = 2e-5 * float(xs.max() + (q * q).sum(1).max())
        err, differ = 0.0, 0
        for lo in range(0, b, 32):
            vp, rp = fu.stage1_select_plain(x, xs, m, q[lo:lo + 32], ov)
            e, d = topk_err(vk[lo:lo + 32], rk[lo:lo + 32], vp, rp, tol,
                            f"stage1 N={n} B={b}")
            err, differ = max(err, e), differ + d
            del vp, rp
        qb = q.to(torch.bfloat16)
        key = f"stage1 N={n} B={b} ov_k={ov}"
        res[key] = {"ms": cuda_ms(torch, run, it if n == N1 else 3),
                    "max_abs_err": err, "queries_differing_at_ties": differ,
                    "gemm_bf16_ms": cuda_ms(torch, lambda: torch.matmul(
                        qb, x.T), 3)}  # noqa: B023
        if prof:
            res[key]["kernel_us"] = kernel_us(torch, run)
        print(f"{key} {res[key]}", flush=True)


def f32(torch, tp, res, it, prof=False) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    x1 = torch.randn(N1, D, device=dev, generator=g) + 0.3
    x1_sq = (x1 * x1).sum(1)
    mask1 = torch.rand(N1, device=dev, generator=g) < 0.9
    q = torch.randn(1024, D, device=dev, generator=g) + 0.3
    x, x_sq, mask = x1[:NF], x1_sq[:NF], mask1[:NF]
    xb = x1.to(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [
        ("k3 f32 B=1024 N=131072 k=200", x, x_sq, mask, 1024, 200, {}, 0),
        ("k1 f32 B=128 N=131072 k=16", x, x_sq, mask, 128, 16, {}, 0),
        ("k1 f32 cosine B=128 N=1M k=16", x1, x1_sq, mask1, 128, 16,
         {"metric": "cosine"}, 0),
        ("k1 f32 cosine B=128 N=1M k=1024", x1, x1_sq, mask1, 128, 1024,
         {"metric": "cosine"}, 0),
        ("k1 f32 dot B=128 N=1M k=16", x1, x1_sq, mask1, 128, 16,
         {"metric": "dot"}, 0),
        ("k1 f32 dot B=128 N=1M k=1024", x1, x1_sq, mask1, 128, 1024,
         {"metric": "dot"}, 0),
        ("k15 flat shard B=128 N=1M k=10", x1, x1_sq, mask1, 128, 10, {}, 0),
        ("k1 f32 large k B=4 N=1M k=1024", x1, x1_sq, mask1, 4, 1024, {}, 0),
        ("k1 f32 large k B=4 N=1M k=16384", x1, x1_sq, mask1, 4, 16_384, {},
         0),
        ("k8 tile step B=32 N=699392 k=10", x1[:699_392], None,
         mask1[:699_392], 32, 10, {"row_base": 699_392}, 0),
        ("k3 bf16 rows B=1024 N=1M k=200", xb, None, mask1, 1024, 200, {},
         1),
        ("k1 bf16 rows oracle B=128 N=524288 k=11", xb[:524_288], None,
         mask1[:524_288], 128, 11, {}, 1),
    ]
    for key, xx, xs, m, b, k, kw, bf in cases:
        qq = q[:b].contiguous()

        def run(xx=xx, xs=xs, m=m, qq=qq, k=k, kw=kw):
            return tp.l2_topk(xx, xs, m, qq, k, **kw)

        vk, rk = run()
        vp, rp = tp.l2_topk_plain(xx, xs, m, qq, k, **kw)
        norms = xs if xs is not None else (xx.float() ** 2).sum(1)
        tol = 1e-5 if kw.get("metric") == "cosine" else \
            2e-5 * float(norms.max() + (qq * qq).sum(1).max())
        err, differ = topk_err(vk, rk, vp, rp, tol, key)
        del vp, rp
        xm = xx.float() if bf else xx
        res[key] = {"ms": cuda_ms(torch, run, it if b * xx.shape[0] < 2**28
                                  else 3),
                    "max_abs_err": err, "queries_differing_at_ties": differ,
                    "gemm_f32_ms": cuda_ms(torch, lambda: torch.matmul(
                        qq, xm.T), 3)}  # noqa: B023
        if bf:
            qh = qq.to(torch.bfloat16)
            res[key]["gemm_bf16_ms"] = cuda_ms(
                torch, lambda: torch.matmul(qh, xx.T), 3)  # noqa: B023
        del xm
        if prof:
            res[key]["kernel_us"] = kernel_us(torch, run)
        print(f"{key} {res[key]}", flush=True)


def near_tie_flips(kk, kp, ids, dd, x, bf16: bool) -> int:
    """Queries whose K4 flags differ from the plain version's; each one's
    first flip must sit at a near-tie of the plain scan (the flags after
    it follow from it)."""
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
            raise SystemExit(f"heuristic_kept: query {r} flips off a tie")
    return len(rows)


def k4_cases(torch) -> list:
    """K4's shapes: (name, rows, candidate ids, their distances, bf16)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    x = torch.randn(NF, D, device=dev, generator=g)
    q = torch.randn(1024, D, device=dev, generator=g)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist = (x * x).sum(1)[None] - 2.0 * q @ x.T + (q * q).sum(1)[:, None]
    dd, ids = torch.topk(dist, 128, dim=1, largest=False, sorted=True)
    del dist
    ids = ids.to(torch.int32)
    xu = torch.empty(NF * D + 1, device=dev)[1:].view(NF, D)
    xu.copy_(x)
    pid, pdd = ids[:, :64].clone(), dd[:, :64].clone()
    pid[:, -8:] = -1
    pdd[:, -8:] = float("inf")
    xb = x.to(torch.bfloat16)
    return [("k4 link f32 B=1024 C=128", x, ids, dd, False),
            ("k4 prune f32 B=1024 C=64", x, pid, pdd, False),
            ("k4 link bf16 B=1024 C=128", xb, ids, dd, True),
            ("k4 prune bf16 B=1024 C=64", xb, pid, pdd, True),
            ("k4 f32 B=1024 C=32", x, ids[:, :32].contiguous(),
             dd[:, :32].contiguous(), False),
            ("k4 link f32 rows off 16 B=1024 C=128", xu, ids, dd, False)]


def k4(torch, hn, res, it, prof=False) -> None:
    route = getattr(hn, "heuristic_route", lambda _: "fma")
    for key, xx, ii, di, bf in k4_cases(torch):
        ii, di = ii.contiguous(), di.contiguous()

        def run(xx=xx, ii=ii, di=di):
            return hn.heuristic_kept(xx, ii, di, 32)

        kk, kp = run(), hn.heuristic_kept_plain(xx, ii, di, 32)
        flips = near_tie_flips(kk, kp, ii, di, xx, bf)
        b, c = ii.shape
        rows = int((ii >= 0).sum())
        nbytes = rows * D * xx.element_size() + b * c * 9
        ops = b * c * (c + 1) / 2 * 2.0 * D
        res[key] = {"ms": cuda_ms(torch, run, it),
                    "plain_ms": cuda_ms(torch, lambda: hn.heuristic_kept_plain(
                        xx, ii, di, 32), 2),  # noqa: B023
                    "route": route(xx), "queries_flipped_at_ties": flips,
                    "bound_bytes_ms": nbytes / 3.35e12 * 1e3,
                    "bound_tc_ms": 3 * ops / 495e12 * 1e3 if not bf
                    else ops / 989e12 * 1e3,
                    "bound_fma_ms": ops / 67e12 * 1e3}
        if prof:  # the device's time alone: below ~0.06 ms a call the
            # wrapper's host time can set the pace of back-to-back calls
            res[key]["kernel_us"] = kernel_us(torch, run, 20)
        print(f"{key} {res[key]}", flush=True)


def pool_share(rk, rp, vk, vp, tol: float, what: str) -> float:
    """The mean share of rows two pools have in common; the shared rows'
    distances must agree within tol."""
    rk, rp, vk, vp = (t.cpu().numpy() for t in (rk, rp, vk, vp))
    shares = []
    for i in range(rk.shape[0]):
        a = dict(zip(rk[i].tolist(), vk[i].tolist()))
        b = dict(zip(rp[i].tolist(), vp[i].tolist()))
        common = [r for r in a if r >= 0 and r in b]
        for r in common:
            if abs(a[r] - b[r]) > tol:
                raise SystemExit(f"{what}: row {r} has another distance")
        shares.append(len(common) / max(1, sum(r >= 0 for r in b)))
    share = float(np.mean(shares))
    if share < 0.99:
        raise SystemExit(f"{what}: pool overlap {share} < 0.99")
    return share


def k9(torch, tp, native, res, it, prof=False, bf16=False) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(N1, D, device=dev, generator=g)
    if bf16:
        x = x.to(torch.bfloat16)
    x_sq = (x.float() ** 2).sum(1)
    mask = torch.rand(N1, device=dev, generator=g) < 0.99
    q = torch.randn(128, D, device=dev, generator=g)
    for b in (1, 128):
        qq = q[:b].contiguous()

        def run(qq=qq):
            return tp.approx_topk(x, x_sq, mask, qq, 128, bf16)

        before = dict(native.launches)
        vk, rk = run()
        pass_ = [k for k, v in native.launches.items() if v != before[k]]
        vp, rp = tp.approx_topk_plain(x, x_sq, mask, qq, 128, bf16)
        key = f"k9 {'bf16' if bf16 else 'f32'} B={b} N=1M ov_k=128"
        tol = 1e-5 * float(x_sq.max() + (qq * qq).sum(1).max())
        share = pool_share(rk, rp, vk, vp, tol, key)
        del vp, rp
        res[key] = {"ms": cuda_ms(torch, run, it), "counted_as": pass_,
                    "pool_overlap_with_plain": share,
                    "bound_bytes_ms": (N1 * (D * x.element_size() + 4 + 1)
                                       + b * D * 4 + b * 128 * 8)
                    / 3.35e12 * 1e3,
                    "bound_tc_ms": (2.0 if bf16 else 6.0) * b * N1 * D
                    / (989e12 if bf16 else 495e12) * 1e3,
                    "bound_fma_ms": 2.0 * b * N1 * D / 67e12 * 1e3}
        if prof:
            res[key]["kernel_us"] = kernel_us(torch, run)
        print(f"{key} {res[key]}", flush=True)


K11_N, K11_EVERY = 1_048_576, 8  # rows of the store; every 8th in the graph
# a pointer chase a thread at a time: the card's dependent global read
CHASE_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* __restrict__ nxt, int hops,
                      long long* out) {
  int p = 0;
  const long long t0 = clock64();
  for (int i = 0; i < hops; ++i) p = nxt[p];
  out[0] = clock64() - t0;
  out[1] = p;
}
extern "C" int fvdb_chase(const int* nxt, int hops, long long* out) {
  chase<<<1, 1>>>(nxt, hops, out);
  return (int)cudaGetLastError();
}
"""


def round_trip_ns(torch, native, root: Path) -> dict:
    """Nanoseconds of one dependent global read by one thread (a chase
    through a random cycle of ints): over 1 GiB (HBM) and 8 MiB (L2)."""
    out_dir = root / "build" / "chase"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chase.cu").write_text(CHASE_SRC)
    r = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-o",
                        str(out_dir / "chase.so"), str(out_dir / "chase.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"chase: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out_dir / "chase.so"))
    lib.fvdb_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    dev = torch.device("cuda")
    khz = torch.cuda.get_device_properties(0).clock_rate if hasattr(
        torch.cuda.get_device_properties(0), "clock_rate") else None
    res = {}
    g = torch.Generator(device=dev).manual_seed(22)
    for tag, n in (("hbm", 1 << 28), ("l2", 1 << 21)):
        perm = torch.randperm(n, device=dev, generator=g).to(torch.int32)
        nxt = torch.empty_like(perm)
        nxt[perm] = torch.roll(perm, 1)  # one cycle through every slot
        out = torch.zeros(2, dtype=torch.int64, device=dev)
        hops = 20_000
        lib.fvdb_chase(nxt.data_ptr(), 1000, out.data_ptr())  # warm
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        err = lib.fvdb_chase(nxt.data_ptr(), hops, out.data_ptr())
        b.record()
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"chase: CUDA error {err}")
        res[f"{tag}_ns"] = a.elapsed_time(b) * 1e6 / hops
        res[f"{tag}_cycles"] = int(out[0]) / hops
        del perm, nxt
    res["sm_clock_khz"] = khz
    return res


BARRIER_SRC = r"""
#include "grid_barrier.cuh"
__global__ void __launch_bounds__(1024, 1) barriers(unsigned* bar, int n) {
  for (int i = 0; i < n; ++i) fvdb::grid_barrier(bar, gridDim.x);
}
extern "C" int fvdb_barriers(unsigned* bar, int n, int threads,
                             void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  void* args[] = {&bar, &n};
  return (int)cudaLaunchCooperativeKernel((const void*)barriers, dim3(sms),
                                          dim3(threads), args, 0,
                                          (cudaStream_t)stream);
}
"""


def grid_barrier_ns(torch, native, root: Path) -> dict:
    """Nanoseconds of one grid barrier (csrc/grid_barrier.cuh, this
    script's tree) across one block of 1,024 threads an SM, by a
    cooperative launch: (time of n barriers - time of none) / n."""
    out_dir = root / "build" / "barrier"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "barrier.cu").write_text(BARRIER_SRC)
    csrc = Path(__file__).resolve().parents[1] / \
        "fabstir_vectordb_tpu_torch" / "csrc"
    r = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-I", str(csrc),
                        "-o", str(out_dir / "barrier.so"),
                        str(out_dir / "barrier.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"barrier: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out_dir / "barrier.so"))
    lib.fvdb_barriers.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    bar = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        err = lib.fvdb_barriers(bar.data_ptr(), n, 1024, stream)
        if err:
            raise SystemExit(f"barrier: CUDA error {err}")

    run(100)  # warm
    torch.cuda.synchronize()
    ms = {}
    for n in (0, 5_000):
        ms[n] = cuda_ms(torch, lambda n=n: run(n), 5, 1)
    return {"ns": (ms[5_000] - ms[0]) * 1e6 / 5_000,
            "launch_ms": ms[0]}


def k7_cases(torch, km, qz) -> list:
    """K7's shapes: (name, call, work) on bench.py's mixture (1,024
    centers, noise 0.35): kmeans_pp_init and kmeans_train at 65,536 x 384,
    C = 256; PQ's seeding at M = 8 and 48; kmeans||'s update (l = 409) and
    counts (2,046) at 10,000 x 384. work: (bytes, f32 ops, TF32 ops,
    barriers)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    centers = torch.randn(1024, D, device=dev, generator=g)
    lab = torch.randint(0, 1024, (65_536,), device=dev, generator=g)
    x = (centers[lab] + 0.35 * torch.randn(65_536, D, device=dev,
                                           generator=g)).contiguous()
    mask = torch.ones(65_536, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x10, m10 = x[:10_000], mask[:10_000]
    cand = torch.randperm(10_000, device=dev, generator=g)[:2_046].to(
        torch.int32)
    d2 = km.seed_min_update_plain(x10, m10, torch.full(
        (10_000,), float("inf"), device=dev), cand[:1])
    l409 = cand[1:410].contiguous()

    def seeds(m):
        if hasattr(qz, "pq_seeds"):
            return lambda: qz.pq_seeds(gen, x, m, 256)
        ds = D // m
        return lambda: torch.stack([
            km.kmeans_pp_init(gen, x[:, j * ds:(j + 1) * ds].contiguous(),
                              mask, 256) for j in range(m)])

    pp = (255 * 65_536 * D * 4 + 256 * 65_536, 255 * 2.0 * 65_536 * D, 0.0,
          256)
    return [
        ("k7 kmeans_pp_init N=65536 D=384 C=256",
         lambda: km.kmeans_pp_init(gen, x, mask, 256), pp),
        ("k7 pq seeding M=8 K=256 N=65536", seeds(8), pp),
        ("k7 pq seeding M=48 K=256 N=65536", seeds(48), pp),
        ("k7 kmeans_train N=65536 D=384 C=256",
         lambda: km.kmeans_train(gen, x, mask, 256), pp),
        ("k7 seed_min_update N=10000 D=384 l=409",
         lambda: km.seed_min_update(x10, m10, d2, l409),
         (10_000 * (D * 4 + 9) + 409 * 4, 0.0, 3 * 2.0 * 409 * 10_000 * D,
          0)),
        ("k7 seed_counts N=10000 D=384 C=2046",
         lambda: km.seed_counts(x10, m10, cand),
         (10_000 * (D * 4 + 1) + 2_046 * 8, 0.0,
          3 * 2.0 * 2_046 * 10_000 * D, 0)),
    ], (x, mask, x10, m10, d2, l409, cand)


def k7_agree(torch, km, native, data) -> dict:
    """The tree's K7 kernels against their plain versions (where the tree
    has the batched k-means++): k-means++ at M = 1, 8 and 48, the table
    update (and its FMA route's error at the same inputs) and the
    counts."""
    if not hasattr(km, "kmeans_pp_rows"):
        return {}
    from tests.test_torch_kmeans_checks import pp_key_gaps

    x, mask, x10, m10, d2, l409, cand = data
    out = {}
    for m in (1, 8, 48):
        rk = km.kmeans_pp_rows(99, x, mask, 256, m)
        rp = km.kmeans_pp_rows(99, x, mask, 256, m, plain=True)
        gaps = pp_key_gaps(99, x, mask, rk, rp, m)
        if any(not g <= 1e-6 for _, _, g in gaps):
            raise SystemExit(f"k7 kmeans_pp M={m}: picks apart off a tie "
                             f"{gaps}")
        out[f"kmeans_pp M={m} subspaces apart at ties"] = len(gaps)
    tol = 1e-6 * float((x10 * x10).sum(1).max())
    err = float((km.seed_min_update(x10, m10, d2, l409)
                 - km.seed_min_update_plain(x10, m10, d2, l409)).abs().max())
    if err > tol:
        raise SystemExit(f"k7 seed_min_update: {err} > {tol}")
    fma = torch.empty_like(d2)
    P, I = native.P, native.I
    native.call("kmeans_seed", "fvdb_seed_min_update",
                [P, P, P, I, I, I, P, P, I, P, P], x10.data_ptr(),
                m10.data_ptr(), l409.data_ptr(), 409, 10_000, D,
                d2.data_ptr(), fma.data_ptr(), 0, 0,
                native.stream_of(x10))
    out["seed_min_update_fma_route_max_abs_err"] = float(
        (fma - km.seed_min_update_plain(x10, m10, d2, l409)).abs().max())
    ck, cp = km.seed_counts(x10, m10, cand), km.seed_counts_plain(x10, m10,
                                                                 cand)
    moved = int((ck - cp).abs().sum()) // 2
    if moved > 10 or int(ck.sum()) != 10_000:
        raise SystemExit(f"k7 seed_counts: {moved} rows moved")
    out.update(seed_min_update_max_abs_err=err, seed_counts_rows_moved=moved)
    return out


def launch_floor_ms(torch, native, it: int = 50):
    """Back-to-back ms of an empty kernel launched through the kernels'
    ctypes path (csrc/kmeans_seed.cu's fvdb_empty_launch), or None where
    the tree has none."""
    try:
        native.fn("kmeans_seed", "fvdb_empty_launch", [native.P])
    except AttributeError:
        return None
    stream = torch.cuda.current_stream().cuda_stream
    return cuda_ms(torch, lambda: native.call(
        "kmeans_seed", "fvdb_empty_launch", [native.P], stream), it)


def k7_picks(torch, km, native, data, res, it) -> None:
    """kmeans||'s pick through ops.kmeans.seed_pick at N = 10,000 (l = 409
    weighted on its d2, l = 1 unweighted), the sharded trainer's N = 10,240
    and IVF training's 16,384 padded rows, 10,000 in the mask (l = 409):
    ms back to back, the card's
    microseconds by kernel (profiler) and behind a sleep, the host's,
    launches (and by shape), torch.equal to the plain version; the bytes'
    bound beside the floor of one launch."""
    x, mask, x10, m10, d2, l409, cand = data
    dev = x.device
    g = torch.Generator(device=dev).manual_seed(25)
    n2, n3 = 10_240, 16_384
    d2b = km.seed_min_update_plain(x[:n2], mask[:n2], torch.full(
        (n2,), float("inf"), device=dev), cand[:1])
    m3 = torch.arange(n3, device=dev) < 10_000  # IVF training's padded rows
    d2c = km.seed_min_update_plain(x[:n3], m3, torch.full(
        (n3,), float("inf"), device=dev), cand[:1])
    floor = launch_floor_ms(torch, native)
    res["launch_floor_ms"] = floor
    for n, l, weighted, dd, mm in ((10_000, 409, True, d2, m10),
                                   (10_000, 1, False, d2, m10),
                                   (n2, 409, True, d2b, mask[:n2]),
                                   (n3, 409, True, d2c, m3)):
        u = torch.rand(n, device=dev, generator=g)
        dw = dd if weighted else None

        def run(dw=dw, mm=mm, u=u, l=l, weighted=weighted):
            return km.seed_pick(dw, mm, u, l, weighted)

        native.shape_launches.clear()
        before = dict(native.launches)
        got = run()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in native.launches.items()
                    if v != before[k]}
        shapes = dict(native.shape_launches)
        us = kernel_us(torch, run, 5)
        key = (f"k7 seed_pick N={n} l={l}"
               + ("" if weighted else " unweighted"))
        nbytes = n * (1 + 4 + (4 if weighted else 0)) + l * 4
        res[key] = {
            "ms": cuda_ms(torch, run, 5 * it),
            "device_us": sum(us.values()), "kernel_us": us,
            "queued_us": queued_us(torch, run),
            "host_us": host_us(torch, run),
            "launches_a_call": launched, "launches_by_shape": shapes,
            "equal_to_plain": bool(torch.equal(got, km.seed_pick_plain(
                dd, mm, u, l, weighted))),
            "bound_bytes_ms": nbytes / 3.35e12 * 1e3,
            "launch_floor_ms": floor}
        print(f"{key} {res[key]}", flush=True)


def k7(torch, km, qz, native, root, res, it) -> None:
    cases, data = k7_cases(torch, km, qz)
    k7_picks(torch, km, native, data, res, it)
    bar = grid_barrier_ns(torch, native, root)
    res["grid_barrier"] = bar
    print(f"grid barrier {bar}", flush=True)
    res["k7 agree"] = k7_agree(torch, km, native, data)
    print(f"k7 agree {res['k7 agree']}", flush=True)
    for key, run, (nbytes, f32_ops, tf32_ops, barriers) in cases:
        native.shape_launches.clear()
        before = dict(native.launches)
        run()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in native.launches.items()
                    if v != before[k]}
        shapes = {k: v for k, v in native.shape_launches.items()
                  if k.startswith(("kmeans_pp", "seed_"))}
        slow = "train" in key or "pq" in key and not hasattr(qz, "pq_seeds")
        us = kernel_us(torch, run, 1)
        res[key] = {"ms": cuda_ms(torch, run, 2 if slow else it, 1),
                    "device_us": sum(us.values()),
                    "kernel_us": dict(list(us.items())[:8]),
                    "queued_us": queued_us(torch, run, 2 if slow else 10),
                    "host_us": host_us(torch, run, 2 if slow else 20),
                    "launches_a_call": launched,
                    "launches_by_shape": shapes,
                    "bound_bytes_ms": nbytes / 3.35e12 * 1e3,
                    "bound_fma_ms": f32_ops / 67e12 * 1e3,
                    "bound_tc_ms": tf32_ops / 495e12 * 1e3,
                    "bound_latency_ms": barriers * bar["ns"] * 1e-6}
        print(f"{key} {res[key]}", flush=True)


def bench_corpus(n: int, d: int, seed: int):
    """bench.py's build_index data, as chip_smoke.py's quant phase makes
    it: 1,024 standard-normal centers, rows 0.35-scaled standard normal
    noise around them (f32, one generator)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, d), dtype=np.float32)
    assign = rng.integers(0, 1024, n)
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= 0.35
    x += centers[assign]
    return x


def codes_at_ties(torch, x, cents, got, want, rel=1e-6) -> int:
    """How many PQ codes differ; raises unless each pair's float64
    distances to the row's subvector tie within rel of |v|^2 + max
    |c|^2."""
    ds = cents.shape[2]
    n_idx, m_idx = torch.nonzero(got != want, as_tuple=True)
    if n_idx.numel():
        cols = m_idx[:, None] * ds + torch.arange(ds, device=x.device)
        v = x[n_idx[:, None], cols].double()
        a = cents[m_idx, got[n_idx, m_idx].long()].double()
        b = cents[m_idx, want[n_idx, m_idx].long()].double()
        gap = (((v - a) ** 2).sum(1) - ((v - b) ** 2).sum(1)).abs()
        scale = (v * v).sum(1) + torch.maximum((a * a).sum(1),
                                               (b * b).sum(1))
        if bool((gap > rel * scale).any()):
            raise SystemExit("k16 encode: a code apart off a tie")
    return int(n_idx.numel())


def k16(torch, native, res, it) -> None:
    from fabstir_vectordb_tpu_torch.ops import quantization as qz

    dev = torch.device("cuda")
    n, b, kc = 1_000_000, 128, 256
    x_np = bench_corpus(n, D, 0)
    rng = np.random.default_rng(11)  # the quant phase's queries
    q = torch.from_numpy(x_np[rng.integers(0, n, b)] + 0.1 * rng.
                         standard_normal((b, D)).astype(np.float32)).to(dev)
    x = torch.from_numpy(x_np).to(dev)
    del x_np
    two = hasattr(qz, "pq_encode_route")
    for m in (8, 48):
        ds = D // m
        gen = torch.Generator(device=dev).manual_seed(0)
        cents = qz.pq_train(gen, x[:65_536], m, kc, 25).centroids
        before = dict(native.launches)
        codes = qz.pq_encode(cents, x)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in native.launches.items()
                    if v != before[k]}
        differ = codes_at_ties(torch, x, cents, codes,
                               qz.pq_encode_plain(cents, x))
        ops = 2.0 * n * kc * D
        key = f"k16 encode M={m} N={n} D={D} K={kc}"
        res[key] = {
            "ms": cuda_ms(torch, lambda: qz.pq_encode(cents, x), it),
            "kernel_us": kernel_us(torch, lambda: qz.pq_encode(cents, x)),
            "launches_a_call": launched, "codes_differing_at_ties": differ,
            "bound_tc_ms": 3 * ops / 495e12 * 1e3,
            "bound_fma_ms": ops / 67e12 * 1e3,
            "bound_bytes_ms": (n * D * 4 + n * m) / 3.35e12 * 1e3}
        if two:  # the FMA route at the same shape, by a direct call
            res[key]["route"] = qz.pq_encode_route(kc, ds)
            out = torch.empty_like(codes)
            P, I = native.P, native.I

            def fma():
                native.call("pq", "fvdb_pq_encode",
                            [P, P, I, I, I, I, I, P, P, P], x.data_ptr(),
                            cents.data_ptr(), n, m, kc, ds, 0, 0,
                            out.data_ptr(), native.stream_of(x))

            fma()
            res[key]["fma_route_ms"] = cuda_ms(torch, fma, it)
            res[key]["fma_route_codes_differing_at_ties"] = codes_at_ties(
                torch, x, cents, out, qz.pq_encode_plain(cents, x))
            del out
        print(f"{key} {res[key]}", flush=True)
        table = qz.pq_adc_table(cents, q)
        ak = qz.pq_adc_distances(table, codes)
        equal = torch.equal(ak, qz.pq_adc_distances_plain(table, codes))
        del ak
        key = f"k16 adc scan M={m} B={b} N={n} K={kc}"
        res[key] = {
            "ms": cuda_ms(torch, lambda: qz.pq_adc_distances(table, codes),
                          it),
            "kernel_us": kernel_us(torch, lambda: qz.pq_adc_distances(
                table, codes)),
            "bit_equal_to_plain": equal,
            "bound_bytes_ms": (b * n * 4 + n * m + b * m * kc * 4)
            / 3.35e12 * 1e3}
        print(f"{key} {res[key]}", flush=True)
        k16_decode(torch, qz, native, cents, codes, m, res, it)
        del codes, table
        torch.cuda.empty_cache()


def k16_decode(torch, qz, native, cents, codes, m, res, it) -> None:
    """K16's decode of the quant phase's codes through
    ops.quantization.pq_decode: ms by CUDA events, device microseconds by
    kernel, launches (and by shape), torch.equal to the plain version, and
    one advanced-indexing gather of the same rows (its int64, clamped
    indices made beforehand) as the library's time."""
    n, kc = codes.shape[0], cents.shape[1]
    native.shape_launches.clear()
    before = dict(native.launches)
    dec = qz.pq_decode(cents, codes)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in native.launches.items()
                if v != before[k]}
    shapes = dict(native.shape_launches)
    equal = bool(torch.equal(dec, qz.pq_decode_plain(cents, codes)))
    del dec
    sub = torch.arange(m, device=codes.device)[None, :]
    idx = codes.long().clamp_max(kc - 1)
    key = f"k16 decode M={m} N={n} D={D} K={kc}"
    res[key] = {
        "ms": cuda_ms(torch, lambda: qz.pq_decode(cents, codes), it),
        "kernel_us": kernel_us(torch, lambda: qz.pq_decode(cents, codes)),
        "library_ms": cuda_ms(torch, lambda: cents[sub, idx], it),
        "launches_a_call": launched, "launches_by_shape": shapes,
        "equal_to_plain": equal,
        "bound_bytes_ms": (n * D * 4 + n * m + m * kc * (D // m) * 4)
        / 3.35e12 * 1e3}
    del idx
    print(f"{key} {res[key]}", flush=True)


def k11_graph(torch):
    """A seeded layered graph over every 8th row of 1,048,576 x 384
    clustered f32 rows (bench.py's mixture: 1,024 centers, noise 0.35):
    layer 0 each member's 32 nearest members, layer l >= 1 (a member's
    level l with probability 16^-l) its 16 nearest of that level, as
    index/hnsw.py's device arrays hold them (nbrs0 [N, 32], nbrs_up read
    at up_offset[id] + l - 1). Exact neighbours by an f32 torch.matmul
    (TF32 off) and torch.topk, not HNSW's heuristic: a walk's shape, not
    its recall, is what is timed."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    centers = torch.randn(1024, D, device=dev, generator=g)
    lab = torch.randint(0, 1024, (K11_N,), device=dev, generator=g)
    x = centers[lab] + 0.35 * torch.randn(K11_N, D, device=dev, generator=g)
    del lab
    x_sq = (x * x).sum(1)
    members = torch.arange(0, K11_N, K11_EVERY, device=dev)
    nm = members.numel()
    torch.backends.cuda.matmul.allow_tf32 = False

    def knn(ids, k):
        xm, sq = x[ids], x_sq[ids]
        out = torch.empty((ids.numel(), k), dtype=torch.int32, device=dev)
        for lo in range(0, ids.numel(), 4096):
            hi = min(ids.numel(), lo + 4096)
            dd = sq[lo:hi, None] - 2.0 * xm[lo:hi] @ xm.T + sq[None]
            dd[torch.arange(hi - lo, device=dev),
               torch.arange(lo, hi, device=dev)] = float("inf")
            out[lo:hi] = ids[torch.topk(dd, k, dim=1, largest=False)[1]
                             ].to(torch.int32)
        return out

    nbrs0 = torch.full((K11_N, 32), -1, dtype=torch.int32, device=dev)
    nbrs0[members] = knn(members, 32)
    u = torch.rand(nm, device=dev, generator=g)
    level = torch.floor(-torch.log(u.clamp_min(1e-12)) / np.log(16)).to(
        torch.int32).clamp_max(4)
    level[0] = int(level.max()) + 1 if int(level.max()) < 4 else 4
    top = int(level.max())
    up_offset = torch.full((K11_N,), -1, dtype=torch.int32, device=dev)
    up_rows = int(level.sum())
    nbrs_up = torch.full((max(up_rows, 1), 16), -1, dtype=torch.int32,
                         device=dev)
    base = torch.cumsum(level, 0) - level
    up_offset[members] = base.to(torch.int32)
    for lay in range(1, top + 1):
        at = members[level >= lay]
        if at.numel() > 1:
            nb = knn(at, min(16, at.numel() - 1))
            rows = up_offset[at].long() + lay - 1
            nbrs_up[rows, :nb.shape[1]] = nb
    mask = torch.zeros(K11_N, dtype=torch.bool, device=dev)
    mask[members] = True
    entry = int(members[0])
    q = (centers[torch.randint(0, 1024, (1024,), device=dev, generator=g)]
         + 0.35 * torch.randn(1024, D, device=dev, generator=g))
    fmask = torch.rand(K11_N, device=dev, generator=g) < 0.5
    return {"x": x, "x_sq": x_sq, "mask": mask, "nbrs0": nbrs0,
            "nbrs_up": nbrs_up, "up_offset": up_offset, "entry": entry,
            "top": top, "q": q, "fmask": fmask, "members": nm}


def k11_cases(torch, hn, gr) -> list:
    """K11's shapes: (name, rows, x_sq, queries, start [B, 1], active,
    layer, ef, W, result mask). Starts by K10's descent (to layer 0, or to
    each query's level for the upper layer: a quarter of the queries at
    each of levels 0-3, so about half take part at layer 2)."""
    x, x_sq, q = gr["x"], gr["x_sq"], gr["q"]
    xb = x.to(torch.bfloat16)
    sq_b = (xb.float() ** 2).sum(1)
    args = (gr["mask"], gr["nbrs_up"], gr["up_offset"])
    cur, _ = hn.greedy_descent(x, x_sq, *args, q, gr["entry"], gr["top"])
    cur_b, _ = hn.greedy_descent(xb, sq_b, *args, q, gr["entry"], gr["top"])
    layer = min(2, gr["top"])
    stop_np = np.minimum(np.arange(1024) % 4, gr["top"]).astype(np.int32)
    stop = torch.from_numpy(stop_np).to(q.device)
    act = torch.from_numpy(stop_np >= layer).to(q.device)
    cu, _ = hn.greedy_descent(x, x_sq, *args, q, gr["entry"], gr["top"], stop)
    cu_b, _ = hn.greedy_descent(xb, sq_b, *args, q, gr["entry"], gr["top"],
                                stop)
    s = cur[:, None].contiguous()
    sb = cur_b[:, None].contiguous()
    fm = gr["fmask"]
    return [
        ("k11 serve f32 B=1 ef=64 W=4", x, x_sq, q[:1], s[:1], None, 0, 64,
         4, None),
        ("k11 serve f32 B=128 ef=64 W=4", x, x_sq, q[:128], s[:128], None, 0,
         64, 4, None),
        ("k11 serve f32 filtered B=128 ef=64 W=4", x, x_sq, q[:128], s[:128],
         None, 0, 64, 4, fm),
        ("k11 serve bf16 B=1 ef=64 W=4", xb, sq_b, q[:1], sb[:1], None, 0, 64,
         4, None),
        ("k11 serve bf16 B=128 ef=64 W=4", xb, sq_b, q[:128], sb[:128], None,
         0, 64, 4, None),
        ("k11 serve bf16 filtered B=128 ef=64 W=4", xb, sq_b, q[:128],
         sb[:128], None, 0, 64, 4, fm),
        ("k11 link f32 B=1024 ef=200 W=1", x, x_sq, q, s, None, 0, 200, 1,
         None),
        ("k11 link bf16 B=1024 ef=200 W=1", xb, sq_b, q, sb, None, 0, 200, 1,
         None),
        (f"k11 upper layer {layer} f32 B=1024 ef=200 W=1", x, x_sq, q,
         cu[:, None].contiguous(), act, layer, 200, 1, None),
        (f"k11 upper layer {layer} bf16 B=1024 ef=200 W=1", xb, sq_b, q,
         cu_b[:, None].contiguous(), act, layer, 200, 1, None),
    ]


def k11(torch, hn, native, root, res, it, prof=False) -> None:
    gr = k11_graph(torch)
    rt = round_trip_ns(torch, native, root)
    res["global_round_trip"] = rt
    print(f"global round trip {rt}", flush=True)
    for (key, x, x_sq, qq, start, act, lay, ef, w, rm) in k11_cases(
            torch, hn, gr):
        args = (x, x_sq, gr["mask"], gr["nbrs0"], gr["nbrs_up"],
                gr["up_offset"], qq, start, act, lay, ef, ef + 32, rm, None,
                w)

        def run(args=args):
            return hn.beam_search(*args)

        _, ik = run()
        st = {}
        _, ip = hn.beam_search_plain(*args, stats=st)
        on = torch.ones(qq.shape[0], dtype=torch.bool, device=qq.device) \
            if act is None else act
        if not torch.equal(ik[~on], ip[~on]):
            raise SystemExit(f"{key}: an inactive query's starts differ")
        ov = k11_overlap(ik[on].cpu().numpy(), ip[on].cpu().numpy())
        if ov < 0.99:
            raise SystemExit(f"{key}: overlap {ov} with the plain version")
        if rm is not None:
            got = ik[ik >= 0].long()
            if not bool(rm[got].all()):
                raise SystemExit(f"{key}: a filtered-out row came back")
        b = qq.shape[0]
        seen = int(st["seen"].sum())
        nbytes = (seen * (D * x.element_size() + 4 + 1)
                  + st["parents"] * 32 * 4 + b * D * 4 + b * ef * 8)
        steps_max = st.get("steps_max", 0)
        res[key] = {"ms": cuda_ms(torch, run, it), "overlap_with_plain": ov,
                    "steps": st["steps"], "steps_max": steps_max,
                    "rows": st["rows"], "distinct_rows": seen,
                    "bound_bytes_ms": nbytes / 3.35e12 * 1e3,
                    "bound_latency_ms": steps_max * rt["hbm_ns"] * 1e-6,
                    "bound_fma_ms": st["rows"] * 2.0 * D / 67e12 * 1e3,
                    "warps_a_query": getattr(hn, "beam_plan", lambda *a: 8)(
                        b, w, 32 if lay == 0 else 16)}
        res[key]["kernel_us"] = kernel_us(torch, run, 5 if b > 1 else 20)
        print(f"{key} {res[key]}", flush=True)


def k11_overlap(a, b) -> float:
    """Mean share of each row's valid ids of b that a holds too."""
    out = []
    for ra, rb in zip(a, b):
        sb = set(rb[rb >= 0].tolist())
        out.append(len(sb & set(ra[ra >= 0].tolist())) / max(len(sb), 1))
    return float(np.mean(out))


def k6_cases(torch) -> list:
    """K6's shapes: (name, call, plain call, rows, C, D, steps, kind):
    the 10M tier's assignment block (1,048,576 x 384 against 256 lists),
    kmeans_train's Lloyd block (65,536 x 384, C = 256, 5 steps), the
    sharded Lloyd partial (1,000,000 rows, S = 1) and the sharded
    assignment's four shard calls (250,000 rows each), PQ's Lloyd block
    (D = 48) and B2's lloyd_step (95% of the rows in the mask); rows drawn
    as bench.py draws them (1,024 centers, noise 0.35), starting
    centroids rows of the set."""
    from fabstir_vectordb_tpu_torch.ops import kmeans as km

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    centers = torch.randn(1024, D, device=dev, generator=g)
    lab = torch.randint(0, 1024, (N1,), device=dev, generator=g)
    x = centers[lab] + 0.35 * torch.randn(N1, D, device=dev, generator=g)
    del lab
    cents = x[torch.randperm(N1, device=dev, generator=g)[:256]].contiguous()
    xb = x[:65_536].contiguous()
    mb = torch.ones(65_536, dtype=torch.bool, device=dev)
    m95 = torch.rand(65_536, device=dev, generator=g) < 0.95
    cb = xb[torch.randperm(65_536, device=dev, generator=g)[:256]].contiguous()
    xp = xb[:, :48].contiguous()
    cp = cb[:, :48].contiguous()
    x1m, m1m = x[:1_000_000], torch.ones(1_000_000, dtype=torch.bool,
                                         device=dev)
    shards = [x1m[i * 250_000:(i + 1) * 250_000] for i in range(4)]
    return [
        ("k6 assign N=1048576 C=256 D=384", lambda: km.assign_clusters(
            x, cents), lambda: km.assign_clusters_plain(x, cents), N1, 256,
         D, 1, "assign"),
        ("k6 lloyd_block N=65536 C=256 D=384 steps=5", lambda: km.lloyd_block(
            xb, mb, cb, 5), lambda: km.lloyd_block_plain(xb, mb, cb, 5),
         65_536, 256, D, 5, "block"),
        ("k6 lloyd_partial N=1000000 C=256 D=384", lambda: km.lloyd_partial(
            x1m, m1m, cents), lambda: km.lloyd_partial_plain(x1m, m1m, cents),
         1_000_000, 256, D, 1, "partial"),
        ("k6 sharded assign 4 x 250000 C=256 D=384", lambda: [
            km.assign_clusters(s, cents) for s in shards], lambda: [
            km.assign_clusters_plain(s, cents) for s in shards], 1_000_000,
         256, D, 1, "assign4"),
        ("k6 lloyd_block pq N=65536 C=256 D=48 steps=5", lambda: km.lloyd_block(
            xp, mb, cp, 5), lambda: km.lloyd_block_plain(xp, mb, cp, 5),
         65_536, 256, 48, 5, "block"),
        ("k6 lloyd_step (B2) N=65536 C=256 D=384 95% masked in",
         lambda: km.lloyd_step(xb, m95, cb), lambda: km.lloyd_step_plain(
             xb, m95, cb), 65_536, 256, D, 1, "step"),
    ]


def k6_agree(kind, got, want) -> dict:
    """How a K6 call compares with its plain version: the share of equal
    assignments, or the centroids' and errors' largest difference."""
    if kind in ("assign", "assign4"):
        got = got if kind == "assign4" else [got]
        want = want if kind == "assign4" else [want]
        eq = sum(int((a[0] == b[0]).sum()) for a, b in zip(got, want))
        n = sum(a[0].numel() for a in got)
        share = eq / n
        if share < 0.999:
            raise SystemExit(f"assignments agree {share} < 0.999")
        d2 = max(float((a[1] - b[1]).abs().max()) for a, b in zip(got, want))
        return {"assign_agree": share, "d2_max_abs_err": d2}
    if kind == "partial":
        return {"sums_max_abs_err": float((got[0] - want[0]).abs().max()),
                "counts_equal": bool(torch_equal(got[1], want[1])),
                "error_rel": abs(float(got[2][0] - want[2][0]))
                / max(float(want[2][0]), 1e-30)}
    return {"centroids_max_abs_err": float((got[0] - want[0]).abs().max()),
            "error_max_rel": float(((got[1] - want[1]).abs()
                                    / want[1].abs().clamp_min(1e-30)).max())}


def torch_equal(a, b) -> bool:
    return bool((a == b).all())


def k6(torch, res, it, prof=False) -> None:
    from fabstir_vectordb_tpu_torch.ops import kmeans as km
    from fabstir_vectordb_tpu_torch.utils import native

    torch.backends.cuda.matmul.allow_tf32 = False
    for key, run, plain, n, c, d, steps, kind in k6_cases(torch):
        before = dict(native.launches)
        got = run()
        counted = [k for k, v in native.launches.items() if v != before[k]]
        res[key] = {"counted_as": counted, **k6_agree(kind, got, plain())}
        del got
        ops = 2.0 * n * c * d * steps
        nbytes = steps * (n * d * 4 + 2 * c * d * 4) + n * 8
        res[key].update({
            "ms": cuda_ms(torch, run, it),
            "plain_ms": cuda_ms(torch, plain, 3),
            "bound_tc_ms": 3 * ops / 495e12 * 1e3,
            "bound_fma_ms": ops / 67e12 * 1e3,
            "bound_bytes_ms": nbytes / 3.35e12 * 1e3,
            "route": getattr(km, "lloyd_route", lambda *a: "fma")(n, c, d)})
        if prof:
            res[key]["kernel_us"] = kernel_us(torch, run, 3)
        print(f"{key} {res[key]}", flush=True)


def k2_cases(torch) -> list:
    """K2's shapes: (name, rows x, queries, pools, m). Seeded bf16 rows
    (1,048,576 x 384, the reduced-rank rerank mirror; 10,485,760 x 384 for
    the 10M tier's OV = 2,048) and the same 1M rows in f32 (the turbo
    pool's re-score), queries near the rows, pools of random rows (-1 in
    the last eighth of the 1M pools, as a short stage 1 pads them); B =
    128 and B = 1 at each, and a filtered k = 100 search's wide pool on
    the radix route."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    xf = torch.randn(N1, D, device=dev, generator=g)
    xb = xf.to(torch.bfloat16)
    x10 = torch.empty((N10, D), dtype=torch.bfloat16, device=dev)
    for lo in range(0, N10, N1):
        x10[lo:lo + N1] = torch.randn(N1, D, device=dev,
                                      generator=g).to(torch.bfloat16)
    near = torch.randint(0, N1, (128,), device=dev, generator=g)
    q = xf[near] + 0.3 * torch.randn(128, D, device=dev, generator=g)

    def pool(n, ov, pad):
        p = torch.randint(0, n, (128, ov), device=dev, generator=g,
                          dtype=torch.int32)
        if pad:
            p[:, -ov // 8:] = -1
        return p.contiguous()

    p1, p10, pf = pool(N1, 1024, True), pool(N10, 2048, False), \
        pool(N1, 128, False)
    wide = pool(N1, 16_384, False)[:4].contiguous()
    out = []
    for b in (128, 1):
        qq = q[:b].contiguous()
        out += [(f"k2 bf16 B={b} OV=1024 m=64", xb, qq, p1[:b], 64),
                (f"k2 bf16 B={b} OV=2048 m=64 (10M)", x10, qq, p10[:b], 64),
                (f"k2 f32 B={b} OV=128 m=16", xf, qq, pf[:b], 16)]
    out.append(("k2 bf16 B=4 OV=16384 m=512 (radix)", xb, q[:4], wide, 512))
    return out


def k2(torch, fu, native, root, res, it) -> None:
    rt = round_trip_ns(torch, native, root)
    res["global_round_trip"] = rt
    print(f"global round trip {rt}", flush=True)
    for key, x, qq, rows, m in k2_cases(torch):
        rows = rows.contiguous()

        def run(x=x, qq=qq, rows=rows, m=m):
            return fu.rerank_f32(x, qq, rows, m)

        vk, rk = run()
        vp, rp = fu.rerank_f32_plain(x, qq, rows, m)
        tol = 1e-5 * float(vp[torch.isfinite(vp)].max())
        err, differ = topk_err(vk, rk, vp, rp, tol, key)
        valid = rows >= 0
        distinct = int(torch.unique(rows[valid]).numel())
        b, ov = rows.shape
        nbytes = (distinct * D * x.element_size() + rows.numel() * 4
                  + b * D * 4 + b * m * 8)
        us = kernel_us(torch, run, 20 if b == 1 else 5)
        res[key] = {"ms": cuda_ms(torch, run, it), "device_us": sum(
                        us.values()), "kernel_us": us,
                    "queued_us": queued_us(torch, run),
                    "host_us": host_us(torch, run), "max_abs_err": err,
                    "rows_differing_at_ties": differ,
                    "distinct_rows": distinct,
                    "bound_bytes_ms": nbytes / 3.35e12 * 1e3,
                    # the pool's row ids, then its rows: two dependent reads
                    "bound_latency_ms": 2 * rt["l2_ns"] * 1e-6}
        print(f"{key} {res[key]}", flush=True)


def k10(torch, hn, native, root, res, it) -> None:
    """K10 on k11_graph's upper layers (levels 1-4 over every 8th row of
    1M x 384, 16 neighbours a list), f32 and bf16 rows, B = 1, 128 and
    1,024 (a link plan's batch), from the entry to layer 0; each held to
    its plain version (99% of walks equal) beside a latency bound (the
    longest query's hop attempts x one dependent read, from L2 and from
    HBM)."""
    gr = k11_graph(torch)
    rt = round_trip_ns(torch, native, root)
    res["global_round_trip"] = rt
    print(f"global round trip {rt}", flush=True)
    x, x_sq, q = gr["x"], gr["x_sq"], gr["q"]
    xb = x.to(torch.bfloat16)
    sq_b = (xb.float() ** 2).sum(1)
    for tag, xx, sq in (("f32", x, x_sq), ("bf16", xb, sq_b)):
        for b in (128, 1, 1024):
            qq = q[:b].contiguous()
            args = (xx, sq, gr["mask"], gr["nbrs_up"], gr["up_offset"], qq,
                    gr["entry"], gr["top"])

            def run(args=args):
                return hn.greedy_descent(*args)

            ck, dk = run()
            st = {}
            cp, dp = hn.greedy_descent_plain(*args, stats=st)
            agree = float((ck == cp).float().mean())
            key = f"k10 {tag} B={b} M=16 levels={gr['top']}"
            if agree < 0.99:
                raise SystemExit(f"{key}: {agree} of walks agree")
            seen = int(st["seen"].sum())
            nbytes = (seen * (D * xx.element_size() + 4 + 1)
                      + st["hops"] * 16 * 4 + b * D * 4 + b * 8)
            longest = st.get("longest")  # None: a tree before it was kept
            us = kernel_us(torch, run, 20 if b == 1 else 5)
            res[key] = {"ms": cuda_ms(torch, run, it), "device_us": sum(
                            us.values()), "kernel_us": us,
                        "queued_us": queued_us(torch, run),
                        "host_us": host_us(torch, run), "agree": agree,
                        "hops": st["hops"], "longest": longest,
                        "distinct_rows": seen,
                        "bound_bytes_ms": nbytes / 3.35e12 * 1e3,
                        "bound_latency_l2_ms": None if longest is None
                        else longest * rt["l2_ns"] * 1e-6,
                        "bound_latency_hbm_ms": None if longest is None
                        else longest * rt["hbm_ns"] * 1e-6}
            print(f"{key} {res[key]}", flush=True)


def print_ptxas(tag: str, log: str) -> None:
    for line in log.splitlines():
        if any(w in line for w in PTXAS_WORDS):
            print(f"ptxas {tag}: {line.strip()}", flush=True)


def split(root: Path, route: str, only=None) -> None:
    """Build the variants of the pass that f32 rows take in root (``route``,
    as its ops.topk.tile_route names it) from root's sources and time each
    in a process of its own."""
    sys.path.insert(0, str(root))
    import torch

    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import native

    want = "tf32x3" if route == "k9f32" else route
    if route not in ("stage1", "k4", "k11", "k6") \
            and tp.tile_route(torch.float32, False, D) != want:
        sys.exit(f"--split {route}: f32 rows take "
                 f"{tp.tile_route(torch.float32, False, D)} in {root}")
    source = SPLIT_SOURCE[route]
    procs = []
    names = []
    for name, patches in SPLITS[route].items():
        if only and name not in only:
            continue
        out = root / "build" / "split" / route / name
        out.mkdir(parents=True, exist_ok=True)
        applied = 0
        for src in [*native.CSRC.glob("*.cuh"), native.CSRC / f"{source}.cu"]:
            text = src.read_text()
            for fname, old, new in patches:
                if fname == src.name:
                    if old not in text:
                        if route == "k11":  # another tree's kernel
                            continue
                        sys.exit(f"{name}: {fname} no longer holds {old!r}")
                    text = text.replace(old, new)
                    applied += 1
            (out / src.name).write_text(text)
        if patches and not applied:
            print(f"split {route} {name}: not in this tree", flush=True)
            continue
        names.append(name)
        procs.append((name, subprocess.Popen(
            [native.nvcc(), *native.NVCC_FLAGS, "-o", str(out / f"{source}.so"),
             str(out / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{name}: nvcc failed\n{log}")
        print_ptxas(f"{route} {name}", log)
    for name in names:
        r = subprocess.run([sys.executable, __file__, "--root", str(root),
                            "--split-variant", f"{route}:{name}"])
        if r.returncode:
            sys.exit(r.returncode)


def split_variant(root: Path, which: str) -> None:
    route, name = which.split(":")
    sys.path.insert(0, str(root))
    import torch

    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import native

    source = SPLIT_SOURCE[route]
    lib = ctypes.CDLL(str(root / "build" / "split" / route / name
                          / f"{source}.so"))
    lib.fvdb_error_string.restype = ctypes.c_char_p
    lib.fvdb_error_string.argtypes = [ctypes.c_int]
    native._libs[source] = lib  # the wrapper calls this copy
    dev = torch.device("cuda")
    out = []
    if route == "k11":
        from fabstir_vectordb_tpu_torch.index import hnsw as hn

        gr = k11_graph(torch)
        for (key, x, x_sq, qq, start, act, lay, ef, w, rm) in k11_cases(
                torch, hn, gr):
            if "bf16" in key or "filtered" in key:
                continue
            args = (x, x_sq, gr["mask"], gr["nbrs0"], gr["nbrs_up"],
                    gr["up_offset"], qq, start, act, lay, ef, ef + 32, rm,
                    None, w)
            us = kernel_us(torch, lambda: hn.beam_search(*args), 5)  # noqa: B023,E501
            out.append(f"{key[4:]} {sum(us.values()):.1f}")
            if hasattr(lib, "fvdb_beam_phase_cycles"):  # the stats variant
                ph = (ctypes.c_longlong * 8)()
                torch.cuda.synchronize()
                lib.fvdb_beam_phase_cycles(ph)
                n = max(ph[4], 1)
                out.append("cycles a pass: parents and candidates %.0f, "
                           "gathers to barrier %.0f, counts and merges "
                           "%.0f, to the last barrier %.0f; passes %d, "
                           "survivors a pass %.1f" % (
                               ph[0] / n, ph[2] / n, ph[7] / n, ph[5] / n,
                               ph[4], ph[6] / n))
        print(f"split {route} {name}: " + "; ".join(out) + " device us",
              flush=True)
        return
    if route == "k6":
        for key, run, *_ in k6_cases(torch):
            if "assign N=" in key or "partial" in key or "D=384 steps" in key:
                out.append(f"{key[3:]} {cuda_ms(torch, run, 5):.4f}")
        print(f"split {route} {name}: " + "; ".join(out) + " ms", flush=True)
        return
    if route == "stage1":
        from fabstir_vectordb_tpu_torch.index import fused as fu

        g = torch.Generator(device=dev).manual_seed(18)
        xp = torch.empty((N10, R), dtype=torch.bfloat16, device=dev)
        for lo in range(0, N10, 1 << 21):
            hi = min(N10, lo + (1 << 21))
            xp[lo:hi] = torch.randn(hi - lo, R, device=dev, generator=g)
        xp_sq = (xp.float() ** 2).sum(1)
        mask = torch.rand(N10, device=dev, generator=g) < 0.9
        qp = torch.randn(128, R, device=dev, generator=g)
        for tag, n, b, ov in (("10M B=1", N10, 1, 2048),
                              ("10M B=128", N10, 128, 2048),
                              ("1M B=128", N1, 128, 1024)):
            x, xs, m, q = xp[:n], xp_sq[:n], mask[:n], qp[:b].contiguous()
            out.append(f"{tag} " + f"{cuda_ms(torch, lambda: fu.stage1_select(x, xs, m, q, ov, 2 << 30), 5):.4f}")  # noqa: B023,E501
        print(f"split {route} {name}: " + "; ".join(out) + " ms", flush=True)
        return
    if route == "k4":
        from fabstir_vectordb_tpu_torch.index import hnsw as hn

        for key, xx, ii, di, _ in k4_cases(torch)[:-1]:
            out.append(f"{key[3:]} {cuda_ms(torch, lambda: hn.heuristic_kept(xx, ii, di, 32), 10):.4f}")  # noqa: B023,E501
        print(f"split {route} {name}: " + "; ".join(out) + " ms", flush=True)
        return
    if route == "k9f32":
        g = torch.Generator(device=dev).manual_seed(21)
        x = torch.randn(N1, D, device=dev, generator=g)
        x_sq = (x * x).sum(1)
        mask = torch.rand(N1, device=dev, generator=g) < 0.99
        q = torch.randn(128, D, device=dev, generator=g)
        for b in (1, 128):
            qq = q[:b].contiguous()
            out.append(f"B={b} {cuda_ms(torch, lambda: tp.approx_topk(x, x_sq, mask, qq, 128), 10):.4f}")  # noqa: B023,E501
        print(f"split {route} {name}: " + "; ".join(out) + " ms", flush=True)
        return
    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn(NF, D, device=dev, generator=g) + 0.3
    x_sq = (x * x).sum(1)
    mask = torch.rand(NF, device=dev, generator=g) < 0.9
    q = torch.randn(1024, D, device=dev, generator=g) + 0.3
    for tag, b, k in (("k3 B=1024 k=200", 1024, 200),
                      ("k1 B=128 k=16", 128, 16)):
        qq = q[:b].contiguous()
        out.append(f"{tag} {cuda_ms(torch, lambda: tp.l2_topk(x, x_sq, mask, qq, k), 5):.4f}")  # noqa: B023,E501
    print(f"split {route} {name}: " + "; ".join(out) + " ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the results' JSON file")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", choices=("stage1", "f32", "k4", "k9f32",
                                       "k9bf16", "k11", "k6", "k2", "k10",
                                       "k7", "k16"),
                    default=None)
    ap.add_argument("--split", choices=tuple(SPLITS), default=None)
    ap.add_argument("--profile", action="store_true",
                    help="add each shape's device time by kernel (one call "
                         "under torch.profiler)")
    ap.add_argument("--variants", default=None,
                    help="with --split: a comma-separated list of the "
                         "variants to build and time (all by default)")
    ap.add_argument("--split-variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    root = Path(args.root).resolve() if args.root else \
        Path(__file__).resolve().parents[1]
    if args.split_variant:
        split_variant(root, args.split_variant)
        return
    if args.split:
        print(f"card: {card_line()}; tree: {root}", flush=True)
        split(root, args.split,
              args.variants.split(",") if args.variants else None)
        return
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import native

    card = card_line()
    print(f"card: {card}; tree: {root}", flush=True)
    t = native.build_all()
    print(f"built in {t:.1f} s", flush=True)
    for name in ("heuristic_kept", "approx_topk", "beam_search", "lloyd",
                 "rerank_f32", "greedy_descent", "kmeans_seed", "pq"):
        print_ptxas(name, native.build_log.get(name, ""))
    res = {"card": card, "tree": root.name}
    if args.only in (None, "stage1"):
        stage1(torch, fu, res, args.iters, args.profile)
        torch.cuda.empty_cache()
    if args.only in (None, "f32"):
        f32(torch, tp, res, args.iters, args.profile)
        torch.cuda.empty_cache()
    if args.only in (None, "k4"):
        k4(torch, hn, res, args.iters, args.profile)
        torch.cuda.empty_cache()
    if args.only in (None, "k9f32"):
        k9(torch, tp, native, res, args.iters, args.profile)
    if args.only in (None, "k9bf16"):
        k9(torch, tp, native, res, args.iters, args.profile, bf16=True)
        torch.cuda.empty_cache()
    if args.only in (None, "k11"):
        k11(torch, hn, native, root, res, args.iters)
        torch.cuda.empty_cache()
    if args.only in (None, "k6"):
        k6(torch, res, args.iters, args.profile)
        torch.cuda.empty_cache()
    if args.only in (None, "k2"):
        k2(torch, fu, native, root, res, args.iters)
        torch.cuda.empty_cache()
    if args.only in (None, "k10"):
        k10(torch, hn, native, root, res, args.iters)
        torch.cuda.empty_cache()
    if args.only in (None, "k7"):
        from fabstir_vectordb_tpu_torch.ops import kmeans as km
        from fabstir_vectordb_tpu_torch.ops import quantization as qz

        k7(torch, km, qz, native, root, res, args.iters)
    if args.only in (None, "k16"):
        k16(torch, native, res, args.iters)
    res["launches"] = {k: v for k, v in native.launches.items() if v}
    print(json.dumps(res), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"time_tile_routes_{root.name}.json").write_text(
        json.dumps(res, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time K14's stage 1, K1 / K3 on f32 rows (and on bf16 rows with an f32
query), K4 and K9 on f32 rows on one NVIDIA GPU, beside yardsticks that the
port never calls.

    python scripts/time_tile_routes.py [--root DIR] [--out DIR] [--iters N]
                                       [--only stage1|f32|k4|k9f32|k9bf16]
                                       [--profile]
                                       [--split fma|tf32x3|stage1|k4|k9f32]

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
blocks an SM). The results are wrong
on purpose, but for "k9f32", whose variants compute the same; only the
time is read. Each variant's ptxas report (registers, spills, serialized
products) is printed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
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
SPLIT_SOURCE = {"fma": "l2_topk", "tf32x3": "l2_topk", "stage1": "l2_topk",
                "k4": "heuristic_kept", "k9f32": "approx_topk"}
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("<")[0].split("(")[0][:60]
            out[name] = out.get(name, 0.0) + e.device_time / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


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


def print_ptxas(tag: str, log: str) -> None:
    for line in log.splitlines():
        if any(w in line for w in PTXAS_WORDS):
            print(f"ptxas {tag}: {line.strip()}", flush=True)


def split(root: Path, route: str) -> None:
    """Build the variants of the pass that f32 rows take in root (``route``,
    as its ops.topk.tile_route names it) from root's sources and time each
    in a process of its own."""
    sys.path.insert(0, str(root))
    import torch

    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import native

    want = "tf32x3" if route == "k9f32" else route
    if route not in ("stage1", "k4") \
            and tp.tile_route(torch.float32, False, D) != want:
        sys.exit(f"--split {route}: f32 rows take "
                 f"{tp.tile_route(torch.float32, False, D)} in {root}")
    source = SPLIT_SOURCE[route]
    procs = []
    for name, patches in SPLITS[route].items():
        out = root / "build" / "split" / route / name
        out.mkdir(parents=True, exist_ok=True)
        for src in [*native.CSRC.glob("*.cuh"), native.CSRC / f"{source}.cu"]:
            text = src.read_text()
            for fname, old, new in patches:
                if fname == src.name:
                    if old not in text:
                        sys.exit(f"{name}: {fname} no longer holds {old!r}")
                    text = text.replace(old, new)
            (out / src.name).write_text(text)
        procs.append((name, subprocess.Popen(
            [native.nvcc(), *native.NVCC_FLAGS, "-o", str(out / f"{source}.so"),
             str(out / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{name}: nvcc failed\n{log}")
        print_ptxas(f"{route} {name}", log)
    for name in SPLITS[route]:
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
                                       "k9bf16"),
                    default=None)
    ap.add_argument("--split", choices=tuple(SPLITS), default=None)
    ap.add_argument("--profile", action="store_true",
                    help="add each shape's device time by kernel (one call "
                         "under torch.profiler)")
    ap.add_argument("--split-variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    root = Path(args.root).resolve() if args.root else \
        Path(__file__).resolve().parents[1]
    if args.split_variant:
        split_variant(root, args.split_variant)
        return
    if args.split:
        print(f"card: {card_line()}; tree: {root}", flush=True)
        split(root, args.split)
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
    for name in ("heuristic_kept", "approx_topk"):
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
    res["launches"] = {k: v for k, v in native.launches.items() if v}
    print(json.dumps(res), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"time_tile_routes_{root.name}.json").write_text(
        json.dumps(res, indent=1))


if __name__ == "__main__":
    main()

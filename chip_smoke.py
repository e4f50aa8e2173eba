#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fabstir_vectordb_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: needs one NVIDIA GPU

1. Probe: the card, torch / CUDA / nvcc versions; build every CUDA kernel
   from ``fabstir_vectordb_tpu_torch/csrc`` (one nvcc each, in parallel).
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, with its time, the plain version's
   time and its bound (the larger of bytes / 3.35 TB/s and f32 flops /
   67 TFLOP/s, the H100 SXM data-sheet rates).
3. Main path: a session (``device=None``: the card) ingests a seeded
   Gaussian mixture of 100,000 x 384 vectors with metadata in batches of
   10,000, answers single, batched and filtered searches, deletes 1,000 ids
   and searches again. Every answer is held against an exact float64 numpy
   brute force. The launch counters, set to 0 just before, must show every
   kernel of the path.
4. One JSON line with every kernel's numbers, the card's name and power
   limit, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero before the last line. ``--phase kernels``
stops after step 2; ``--profile``
writes cProfiles of step 3's ingest and searches to ``--out`` (the timings
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (no TF32)


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


def bound(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


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


def topk_check(tag, vk, rk, vp, rp, tol):
    """Kernel top-k (vk, rk) against the plain one (vp, rp). The kernel's
    list comes out ascending. After sorting both by (distance, row), the
    distances agree within tol element by element. Where the rows of a
    query differ (a swap at a tie), a row in both lists has the same
    distance within tol in each, and a row in one list only must tie the
    k-th within tol. Returns (max_abs_err, queries differing)."""
    vk, rk, vp, rp = (t.cpu().numpy() for t in (vk, rk, vp, rp))
    what = f"l2_topk[{tag}]"
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
        err, differ = topk_check(tag, vk, rk, vp, rp, tol)
        ms = cuda_ms(torch, lambda: tp.l2_topk(x, x_sq, mask, q, k))
        pms = cuda_ms(torch, lambda: tp.l2_topk_plain(x, x_sq, mask, q, k),
                      iters=3)
        bms, by = bound(n * d * 4 + n * 4 + n + b * d * 4 + b * k * 8,
                        2.0 * b * n_in * d)
        results[f"l2_topk[{tag}]"] = dict(
            shape=f"B={b} N={n} D={d} k={k} mask={n_in / n:.3f}",
            max_abs_err=err, tol=tol, rows_differing_at_ties=differ, ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by)
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
        rows = (kk != kp).any(1).nonzero().flatten().tolist()
        xs = x.double()
        for r in rows:  # a flip must sit at a near-tie of the plain scan
            i = int((kk[r] != kp[r]).nonzero()[0])
            v = xs[ids[r].clamp_min(0).long()]
            before = kp[r, :i].nonzero().flatten()
            pd = ((v[i] - v[before]) ** 2).sum(-1)
            dmin = float(pd.min()) if pd.numel() else float("inf")
            if abs(float(dd[r, i]) - dmin) > 1e-5 * float(dd[r, i]):
                fail(f"heuristic_kept[{tag}]: row {r} differs off a tie")
        ms = cuda_ms(torch, lambda: hn.heuristic_kept(x, ids, dd, 32))
        pms = cuda_ms(torch, lambda: hn.heuristic_kept_plain(x, ids, dd, 32),
                      iters=3)
        b = ids.shape[0]
        n_valid = int((ids >= 0).sum())
        bms, by = bound(n_valid * d * 4 + b * c * 9,
                        b * c * (c + 1) / 2 * 2.0 * d)
        results[f"heuristic_kept[{tag}]"] = dict(
            shape=f"B={b} C={c} D={d} m=32",
            max_abs_err=float((kk != kp).any().item()),
            rows_differing_at_ties=len(rows), ms=ms, plain_ms=pms,
            bound_ms=bms, bound_by=by)

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
        ck, ek = km.lloyd_block(xt, mk, init, 5)
        cp, ep = km.lloyd_block_plain(xt, mk, init, 5)
        ak, _ = km.assign_clusters(xt, init, mk)
        ap, _ = km.assign_clusters_plain(xt, init, mk)
        torch.cuda.synchronize()
        err = float((ck - cp).abs().max())
        scale = float(xt.abs().max())
        tol = 1e-5 * scale
        if err > tol or not torch.allclose(ek, ep, rtol=1e-4, atol=1e-3):
            fail(f"lloyd_block[{tag}]: centroids off by {err} (tol {tol}), "
                 f"errors {ek.tolist()} vs {ep.tolist()}")
        if not bool((ak == ap).all()):
            fail(f"assign_clusters[{tag}]: assignments differ")
        steps = 5
        bms, by = bound(steps * (nn * d * 4 + 2 * cc * d * 4) + nn,
                        steps * 2.0 * valid * cc * d)
        results[f"lloyd_block[{tag}]"] = dict(
            shape=f"N={nn} (valid {valid}) C={cc} D={d} steps={steps}",
            max_abs_err=err, tol=tol,
            ms=cuda_ms(torch, lambda: km.lloyd_block(xt, mk, init, 5)),
            plain_ms=cuda_ms(torch,
                             lambda: km.lloyd_block_plain(xt, mk, init, 5)),
            bound_ms=bms, bound_by=by)
    for name, r in results.items():
        print(f"kernel {name}: agree=True library_ms=None " + " ".join(
            f"{k}={v}" for k, v in r.items()), flush=True)


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
    for name in ("heuristic_kept", "pair_sq_l2", "lloyd_block"):
        counts[name] = native.launches[name]
    for name, c in counts.items():
        if c <= 0:
            fail(f"main path: {name} was launched no time")
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


REPLACES = {  # the JAX function each kernel (entry) takes the place of
    "l2_topk": "fabstir_vectordb_tpu/index/fused.py:51",
    "l2_topk[candidates]": "fabstir_vectordb_tpu/index/hnsw.py:81",
    "heuristic_kept": "fabstir_vectordb_tpu/index/hnsw.py:160",
    "pair_sq_l2": "fabstir_vectordb_tpu/index/hnsw.py:222",
    "lloyd_block": "fabstir_vectordb_tpu/ops/kmeans.py:112",
}
SOURCES = {
    "l2_topk": "fabstir_vectordb_tpu_torch/csrc/l2_topk.cu",
    "heuristic_kept": "fabstir_vectordb_tpu_torch/csrc/heuristic_kept.cu",
    "pair_sq_l2": "fabstir_vectordb_tpu_torch/csrc/pair_sq_l2.cu",
    "lloyd_block": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels"), default="all")
    ap.add_argument("--profile", action="store_true",
                    help="cProfile the main path into --out (its timings "
                         "then carry the profiler's overhead)")
    ap.add_argument("--trace", action="store_true",
                    help="torch.profiler over 64 single and 4 batched "
                         "searches: device busy share, ops by device time")
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
    kernels_phase(torch, tp, hn, km, dev, results)
    counts: dict = {}
    perf: dict = {}
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
    kernels = []
    for key, r in results.items():
        base = key.split("[")[0]
        launches = counts.get(key, counts.get(base, 0))
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES.get(key, REPLACES[base]),
            "launches": int(launches),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    if perf:
        print("main_path " + json.dumps(perf), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s; card: {card}",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fabstir_vectordb_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: needs one NVIDIA GPU

1. Probe: the card, torch / CUDA / nvcc versions; build every CUDA kernel
   from ``fabstir_vectordb_tpu_torch/csrc`` (one nvcc each, in parallel).
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, with its time, the plain version's
   time and its bound (the larger of bytes / 3.35 TB/s and f32 flops /
   67 TFLOP/s, the H100 SXM data-sheet rates).
3. Main path, flat regime: a session (``device=None``: the card) ingests a
   seeded Gaussian mixture of 100,000 x 384 vectors with metadata in
   batches of 10,000, answers single, batched and filtered searches,
   deletes 1,000 ids and searches again. Every answer is held against an
   exact float64 numpy brute force. The launch counters, set to 0 just
   before, must show every kernel of the path.
4. Pruned phase: bench.py's 1M tier (1,000,000 x 384, 10% recent rows in
   HNSW, 90% in a 256-list IVF) built through ``HybridIndex.insert_batch``,
   then served in the pruned regime (FVDB_PCA_SERVE=0, flat threshold 0, as
   bench.py forces it): single and batched k=10 searches with recall@10
   against the flat regime's exact answers, per-engine k, filtered searches
   at k=10 and 100, k=300, 1,000 deletes (the entry point among them), and
   2,048 inserts linked through the beam plan. The counters must show K1,
   K4, K5, K6, K10, K11 and K12. Then K10, K11, K12, K13 and K1 at k =
   1,024 and 16,384 against their plain versions on the index's own state.
5. One JSON line with every kernel's numbers, the card's name and power
   limit, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero before the last line. ``--phase kernels``
stops after step 2, ``--phase pruned`` runs steps 1 and 4 only;
``--profile``
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
PRUNED_ROWS = 1_000_000  # bench.py's 1M tier (build_index)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (no TF32)
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


def pruned_phase(torch, native, card: str, perf: dict, results: dict,
                 launch_of: dict, trace=False, out_dir="smoke_out"):
    """bench.py's 1M index, served in the pruned regime, and its kernels
    against their plain versions on the index's own device state."""
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.index import hnsw as hn
    from fabstir_vectordb_tpu_torch.index import ivf as iv
    from fabstir_vectordb_tpu_torch.index.hybrid import (
        HybridConfig, HybridIndex, SearchConfig)
    from fabstir_vectordb_tpu_torch.index.ivf import IVFConfig
    from fabstir_vectordb_tpu_torch.ops import kmeans as km
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import limits

    n, d = PRUNED_ROWS, 384
    n_recent = n // 10
    t0 = time.perf_counter()
    x, centers = bench_corpus(n, d, seed=0)
    print(f"pruned: corpus {n} x {d} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    h = HybridIndex(d, HybridConfig(
        ivf=IVFConfig(n_clusters=256, n_probe=16, train_size=10_000, seed=0),
        auto_migrate=False), device=None)
    cfg = SearchConfig(auto_migrate=False)
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

    native.reset_launches()
    # K7 (kmeans|| seeding, plain torch) is timed inside the training
    k7 = {}
    seeding = km.kmeans_scalable_init

    def timed_seeding(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = seeding(*a, **kw)
        torch.cuda.synchronize()
        k7["s"] = time.perf_counter() - t
        return out

    km.kmeans_scalable_init = timed_seeding
    try:
        t = time.perf_counter()
        h.initialize(x[:10_000])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
    finally:
        km.kmeans_scalable_init = seeding
    ts = np.full(n, NOW - 30 * DAY)
    ts[:n_recent] = NOW - DAY
    t = time.perf_counter()
    h.insert_batch([f"v{i}" for i in range(n)], x, ts, now=NOW)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t
    if h.hnsw.num_nodes != n_recent or h.ivf.active_count != n - n_recent:
        fail(f"pruned: {h.hnsw.num_nodes} HNSW / {h.ivf.active_count} IVF")
    lens = np.bincount(h.ivf.assignments[h.ivf.assignments >= 0],
                       minlength=256)
    print(f"pruned: IVF trained in {train_s:.3f} s, K7 (kmeans|| seeding, "
          f"plain torch) {k7['s'] * 1e3:.3f} ms; inserted {n} rows "
          f"({n_recent} HNSW) in {ingest_s:.3f} s: {n / ingest_s:.1f} "
          f"vectors/s; lists {lens.min()}-{lens.max()} rows, L_pad "
          f"{h.ivf.tiles().shape[1]} ({card})", flush=True)

    rng = np.random.default_rng(5)

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
    for name in ("l2_topk", "l2_topk_large", "heuristic_kept", "pair_sq_l2",
                 "lloyd_block", "greedy_descent", "beam_search", "ivf_scan"):
        if counts[name] <= 0:
            fail(f"pruned path: {name} was launched no time")
    p50 = float(np.percentile(lat, 50))
    qps = 1024 / batch_s
    perf.update(pruned_ingest_vectors_per_s=n / ingest_s,
                pruned_train_s=train_s, k7_seeding_ms=k7["s"] * 1e3,
                pruned_state_build_s=state_s, pruned_search_p50_ms=p50,
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
    q_bytes = 128 * d * 4
    m_up = int(st["nbrs_up"].shape[1])
    hm = st["hnsw_mask"]
    fm = torch.from_numpy(fmask[:x_d.shape[0]]).to(dev)

    # K10
    ck, dk = hn.greedy_descent(x_d, xsq_d, hm, st["nbrs_up"],
                               st["up_offset"], qd, st["entry"],
                               st["entry_level"])
    gst = {}
    cp, dp = hn.greedy_descent_plain(x_d, xsq_d, hm, st["nbrs_up"],
                                     st["up_offset"], qd, st["entry"],
                                     st["entry_level"], stats=gst)
    same = (ck == cp)
    agree = float(same.float().mean())
    if agree < 0.99:
        fail(f"greedy_descent: {agree} of queries agree with plain")
    err = float((dk - dp)[same].abs().max())
    # bytes: each distinct row scored once, each hop's list; flops: every
    # (query, row) distance
    seen = int(gst["seen"].sum())
    work["greedy_descent"] = (seen * (d * 4 + 4) + gst["hops"] * m_up * 4
                              + q_bytes, gst["rows"] * 2.0 * d)
    bms, by = bound(*work["greedy_descent"])
    results["greedy_descent"] = dict(
        shape=f"B=128 M={m_up} D={d} levels={st['entry_level']}",
        max_abs_err=err, agree=agree, hops=gst["hops"], rows=gst["rows"],
        distinct_rows=seen,
        ms=cuda_ms(torch, lambda: hn.greedy_descent(
            x_d, xsq_d, hm, st["nbrs_up"], st["up_offset"], qd, st["entry"],
            st["entry_level"])),
        plain_ms=cuda_ms(torch, lambda: hn.greedy_descent_plain(
            x_d, xsq_d, hm, st["nbrs_up"], st["up_offset"], qd, st["entry"],
            st["entry_level"]), iters=2, warmup=1),
        bound_ms=bms, bound_by=by)
    launch_of["greedy_descent"] = counts["greedy_descent"]

    # K11: serve (ef 64, W 4, +- the filter) and link (ef 200, W 1)
    ex_h = tp.l2_topk(x_d, xsq_d, hm, qd, 10)[1].cpu().numpy()
    ex_hf = tp.l2_topk(x_d, xsq_d, hm & fm, qd, 10)[1].cpu().numpy()
    ql = torch.from_numpy(new[:1024]).to(dev)
    cl, _ = hn.greedy_descent(x_d, xsq_d, hm, st["nbrs_up"], st["up_offset"],
                              ql, st["entry"], st["entry_level"])
    for tag, qq, start, ef, w, rm, exact in (
            ("serve", qd, ck, 64, limits.beam_expand(), None, ex_h),
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
            steps=bst["steps"], rows=bst["rows"], distinct_rows=seen,
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
    # the rows of each list that pass the mask: every (query, probed list)
    # scores them (the flops), but a bound reads each probed list once
    tl = lists.tiles
    live = ((tl >= 0) & st["ivf_mask"][tl.clamp_min(0).long()]).sum(1)
    pairs = int(live[pk.long()].sum())
    union = torch.unique(pk.long())
    rows_once = int(live[union].sum())
    entries_once = int(lists.list_len[union].sum())
    n_c = int(lists.centroids.shape[0])
    work["ivf_scan"] = (rows_once * (d * 4 + 4) + entries_once * (4 + 1)
                        + n_c * d * 4 + q_bytes + 128 * k_srv * 8,
                        2.0 * d * (pairs + 128 * n_c))
    bms, by = bound(*work["ivf_scan"])
    results["ivf_scan"] = dict(
        shape=f"B=128 C={n_c} n_probe=16 k={k_srv} L_pad={tl.shape[1]} "
              f"(query, row) pairs={pairs} distinct rows={rows_once}",
        max_abs_err=err, tol=tol, rows_differing_at_ties=differ,
        peak_bytes=k12_mem,
        ms=cuda_ms(torch, lambda: iv.ivf_search(*ivf_args)),
        plain_ms=cuda_ms(torch, lambda: iv.ivf_search_plain(*ivf_args),
                         iters=2, warmup=1),
        bound_ms=bms, bound_by=by)
    launch_of["ivf_scan"] = counts["ivf_scan"]
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
        bms, by = bound(nn * d * 4 + nn * 4 + nn + 4 * d * 4 + 4 * k * 8,
                        2.0 * 4 * n_in * d)
        results[f"l2_topk[k={k}]"] = dict(
            shape=f"B=4 N={nn} D={d} k={k}", max_abs_err=err, tol=tol,
            rows_differing_at_ties=differ,
            ms=cuda_ms(torch, lambda: tp.l2_topk(x_d, xsq_d, mem, q4, k)),
            plain_ms=cuda_ms(torch, lambda: tp.l2_topk_plain(
                x_d, xsq_d, mem, q4, k), iters=2, warmup=1),
            bound_ms=bms, bound_by=by)
        launch_of[f"l2_topk[k={k}]"] = counts["l2_topk_large"]
    for name in [k for k in results if k in launch_of]:
        r = results[name]
        print(f"kernel {name}: agree=True library_ms=None " + " ".join(
            f"{k}={v}" for k, v in r.items()), flush=True)
    regime(False)


REPLACES = {  # the JAX function each kernel (entry) takes the place of
    "l2_topk": "fabstir_vectordb_tpu/index/fused.py:51",
    "l2_topk[candidates]": "fabstir_vectordb_tpu/index/hnsw.py:81",
    "heuristic_kept": "fabstir_vectordb_tpu/index/hnsw.py:160",
    "pair_sq_l2": "fabstir_vectordb_tpu/index/hnsw.py:222",
    "lloyd_block": "fabstir_vectordb_tpu/ops/kmeans.py:112",
    "greedy_descent": "fabstir_vectordb_tpu/index/hnsw.py:249",
    "beam_search": "fabstir_vectordb_tpu/index/hnsw.py:312",
    "ivf_scan": "fabstir_vectordb_tpu/index/ivf.py:79",
}
SOURCES = {
    "l2_topk": "fabstir_vectordb_tpu_torch/csrc/l2_topk.cu",
    "heuristic_kept": "fabstir_vectordb_tpu_torch/csrc/heuristic_kept.cu",
    "pair_sq_l2": "fabstir_vectordb_tpu_torch/csrc/pair_sq_l2.cu",
    "lloyd_block": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "greedy_descent": "fabstir_vectordb_tpu_torch/csrc/greedy_descent.cu",
    "beam_search": "fabstir_vectordb_tpu_torch/csrc/beam_search.cu",
    "ivf_scan": "fabstir_vectordb_tpu_torch/csrc/ivf_scan.cu",
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "pruned"),
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
    if args.phase != "pruned":
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
    if args.phase in ("all", "pruned"):
        t = time.perf_counter()
        pruned_phase(torch, native, card, perf, results, launch_of,
                     trace=args.trace, out_dir=args.out)
        print(f"pruned phase: {time.perf_counter() - t:.1f} s", flush=True)
    kernels = []
    for key, r in results.items():
        base = key.split("[")[0]
        launches = launch_of.get(key, counts.get(key, counts.get(base, 0)))
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES.get(key, REPLACES[base]),
            "launches": int(launches),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    if perf:
        print("main_path " + json.dumps(perf, default=float), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s; card: {card}",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fabstir_vectordb_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the full run: needs one NVIDIA GPU

1. Probe: the card, torch / CUDA / nvcc versions; build every CUDA kernel
   from ``fabstir_vectordb_tpu_torch/csrc`` (one nvcc each, in parallel).
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, with its time, the plain version's
   time and its bound (the larger of bytes / 3.35 TB/s and flops / 67
   TFLOP/s f32, or 989 TFLOP/s for bf16 products, the H100 SXM data-sheet
   rates).
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
   plan. The counters must show K1, K4, K5, K6, K10, K11 and K12. Then K10,
   K11, K12, K13 and K1 at k = 1,024 and 16,384 against their plain
   versions on the index's own state.
6. Reduced phase: the same index in the reduced-rank regime, the default
   above the flat threshold, as bench.py's bench_pca serves it (flat
   threshold 0, FVDB_PCA_RERANK=device, rank and oversample auto): the
   state build, 100 single and 8 x 128 batched k=10 searches, recall@10
   against the flat regime's exact answers, filtered searches, no full-dim
   f32 mirror held; host stage 2, the pinned restart, 1,000 deletes and a
   fresh insert, the release on FVDB_PCA_SERVE=0. The counters must show
   K14 (selection, projection), K2, K8 and K1 on bf16 rows; then each
   against its plain version on the regime's own state.
7. One JSON line with every kernel's numbers, the card's name and power
   limit, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero before the last line. ``--phase kernels``
stops after step 2, ``--phase pruned`` runs steps 1, 4 and 5 only,
``--phase reduced`` steps 1, 4 and 6; ``--profile``
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
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
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
    k7_names = ("seed_pick", "seed_min_update", "seed_counts")
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
    """K7's three kernels against their plain versions at the IVF training
    shape (the first 10,000 rows, l = 409, 2,046 candidates)."""
    from fabstir_vectordb_tpu_torch.ops import kmeans as km

    d = ctx["d"]
    dev = ctx["h"].store.device
    x = torch.from_numpy(ctx["x"][:10_000]).to(dev)
    n = x.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    first = km.seed_pick_plain(None, mask, torch.rand(n, device=dev,
                                                      generator=g), 1, False)
    d2 = km.seed_min_update_plain(x, mask, torch.full(
        (n,), float("inf"), device=dev), first)
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
    dk = km.seed_min_update(x, mask, d2, rk)
    dp = km.seed_min_update_plain(x, mask, d2, rk)
    x_sq_max = float((x * x).sum(1).max())
    tol = 2e-5 * 2 * x_sq_max
    err = float((dk - dp).abs().max())
    if err > tol:
        fail(f"seed_min_update: max_abs_err {err} > {tol}")
    results["seed_min_update"] = dict(
        shape=f"N={n} D={d} l={l}", max_abs_err=err, tol=tol,
        ms=cuda_ms(torch, lambda: km.seed_min_update(x, mask, d2, rk)),
        plain_ms=cuda_ms(torch, lambda: km.seed_min_update_plain(
            x, mask, d2, rk)), library_ms=None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n * d * 4 + n * 9 + l * 4, 2.0 * l * n * d))))
    cand = torch.cat([first, rk] + [km.seed_pick_plain(
        dp, mask, torch.rand(n, device=dev, generator=g), l)
        for _ in range(4)])[:c_all].contiguous()
    ck = km.seed_counts(x, mask, cand)
    cp = km.seed_counts_plain(x, mask, cand)
    agree = float((ck == cp).float().mean())
    if int(ck.sum()) != n or agree < 0.99:
        fail(f"seed_counts: {agree} of counts agree, sum {int(ck.sum())}")
    results["seed_counts"] = dict(
        shape=f"N={n} D={d} C={c_all}", max_abs_err=float(
            (ck - cp).abs().max()), agree=agree,
        ms=cuda_ms(torch, lambda: km.seed_counts(x, mask, cand)),
        plain_ms=cuda_ms(torch, lambda: km.seed_counts_plain(x, mask, cand)),
        library_ms=None,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(n * d * 4 + n + c_all * 8, 2.0 * c_all * n * d))))


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
    for name in ("greedy_descent", "beam_search[serve]",
                 "beam_search[serve-filtered]", "beam_search[link]",
                 "ivf_scan", "l2_topk[k=1024]", "l2_topk[k=16384]"):
        print_kernel(name, results[name], launch_of[name])
    regime(False)


def print_kernel(name: str, r: dict, launches=None) -> None:
    print(f"kernel {name}: agree=True launches={launches} library_ms="
          f"{r.get('library_ms')} " + " ".join(
              f"{k}={v}" for k, v in r.items() if k != "library_ms"),
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
    print(f"reduced: launches { {k: counts[k] for k in path} }", flush=True)
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
            bound_by=f"{by} (bf16 tensor-core rate)")
        launch_of[key] = counts["stage1_select"]
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
    bms, by = bound(blk_n * (d * 2 + r * 2 + 4) + d * r * 4 + d * 4,
                    2.0 * blk_n * d * r)
    results["project_rows"] = dict(
        shape=f"n={blk_n} D={d} r={r}", max_abs_err=float(
            (yk - yp).abs().max()), equal_share=share, norm_rel_err=sq_err,
        ms=cuda_ms(torch, lambda: fu.project_rows(blk, mu, pm, out_k, sq_k,
                                                  0)),
        plain_ms=cuda_ms(torch, lambda: fu.project_rows_plain(
            blk, mu, pm, out_p, sq_p, 0), iters=2, warmup=1),
        library_ms=cuda_ms(torch, lambda: torch.matmul(centered, pm)),
        bound_ms=bms, bound_by=by)
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
        ms=cuda_ms(torch, lambda: fu.project_queries(q128, mu, pm)),
        plain_ms=cuda_ms(torch, lambda: fu.project_queries_plain(
            q128, mu, pm)),
        library_ms=cuda_ms(torch, lambda: torch.matmul(qc, pm)),
        bound_ms=bms, bound_by=by)
    launch_of["project_queries"] = counts["project_queries"]
    # K2 on the serving pool of 128 queries
    _, pool = fu.stage1_select(xp, xp_sq, mem, qp128, ov_serve)
    vk, rk = fu.rerank_f32(rx, q128, pool, m_serve)
    vp, rp = fu.rerank_f32_plain(rx, q128, pool, m_serve)
    tol = 1e-5 * float(vp[torch.isfinite(vp)].max())
    err, differ = topk_check("rerank_f32", vk, rk, vp, rp, tol)
    valid = pool >= 0
    distinct = int(torch.unique(pool[valid]).numel())
    bms, by = bound(distinct * d * 2 + pool.numel() * 4 + 128 * d * 4
                    + 128 * m_serve * 8, 3.0 * int(valid.sum()) * d)
    results["rerank_f32"] = dict(
        shape=f"B=128 OV={ov_serve} m={m_serve} D={d} distinct rows "
              f"{distinct}", max_abs_err=err, tol=tol,
        rows_differing_at_ties=differ,
        ms=cuda_ms(torch, lambda: fu.rerank_f32(rx, q128, pool, m_serve)),
        plain_ms=cuda_ms(torch, lambda: fu.rerank_f32_plain(
            rx, q128, pool, m_serve), iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by)
    launch_of["rerank_f32"] = counts["rerank_f32"]
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
    bms, by = bound(blk_n * (d * 2 + 1) + 128 * d * 4 + 128 * width * 8,
                    2.0 * 128 * b_in * d + 2.0 * blk_n * d)
    results["l2_topk[bf16]"] = dict(
        shape=f"B=128 N={blk_n} D={d} k={width} (bf16 rows, norms in the "
              f"kernel)", max_abs_err=err1, tol=tol,
        rows_differing_at_ties=differ1, oracle_step_err=err,
        oracle_step_rows_differing_at_ties=differ,
        ms=cuda_ms(torch, lambda: tp.l2_topk(blk, None, m0, q128, width)),
        plain_ms=cuda_ms(torch, lambda: tp.l2_topk_plain(
            blk, None, m0, q128, width), iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by)
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
                 "rerank_f32", "l2_topk[bf16]", "merge_topk"):
        print_kernel(name, results[name], launch_of[name])
    del proj, xp, xp_sq, rx, blk, out_k, out_p, sq_k, sq_p, pool

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


REPLACES = {  # the JAX function each kernel (entry) takes the place of
    "l2_topk": "fabstir_vectordb_tpu/index/fused.py:51",
    "l2_topk[candidates]": "fabstir_vectordb_tpu/index/hnsw.py:81",
    "heuristic_kept": "fabstir_vectordb_tpu/index/hnsw.py:160",
    "pair_sq_l2": "fabstir_vectordb_tpu/index/hnsw.py:222",
    "lloyd_block": "fabstir_vectordb_tpu/ops/kmeans.py:112",
    "greedy_descent": "fabstir_vectordb_tpu/index/hnsw.py:249",
    "beam_search": "fabstir_vectordb_tpu/index/hnsw.py:312",
    "ivf_scan": "fabstir_vectordb_tpu/index/ivf.py:79",
    "l2_topk[bf16]": "fabstir_vectordb_tpu/index/fused.py:206",
    "seed_pick": "fabstir_vectordb_tpu/ops/kmeans.py:150",
    "seed_min_update": "fabstir_vectordb_tpu/ops/kmeans.py:130",
    "seed_counts": "fabstir_vectordb_tpu/ops/kmeans.py:140",
    "stage1_select": "fabstir_vectordb_tpu/index/fused.py:65",
    "project_rows": "fabstir_vectordb_tpu/index/fused.py:197",
    "project_queries": "fabstir_vectordb_tpu/index/fused.py:741",
    "rerank_f32": "fabstir_vectordb_tpu/index/fused.py:83",
    "merge_topk": "fabstir_vectordb_tpu/ops/topk.py:61",
}
SOURCES = {
    "l2_topk": "fabstir_vectordb_tpu_torch/csrc/l2_topk.cu",
    "heuristic_kept": "fabstir_vectordb_tpu_torch/csrc/heuristic_kept.cu",
    "pair_sq_l2": "fabstir_vectordb_tpu_torch/csrc/pair_sq_l2.cu",
    "lloyd_block": "fabstir_vectordb_tpu_torch/csrc/lloyd.cu",
    "greedy_descent": "fabstir_vectordb_tpu_torch/csrc/greedy_descent.cu",
    "beam_search": "fabstir_vectordb_tpu_torch/csrc/beam_search.cu",
    "ivf_scan": "fabstir_vectordb_tpu_torch/csrc/ivf_scan.cu",
    "seed_pick": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "seed_min_update": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "seed_counts": "fabstir_vectordb_tpu_torch/csrc/kmeans_seed.cu",
    "stage1_select": "fabstir_vectordb_tpu_torch/csrc/stage1_select.cu",
    "project_rows": "fabstir_vectordb_tpu_torch/csrc/project_rows.cu",
    "project_queries": "fabstir_vectordb_tpu_torch/csrc/project_rows.cu",
    "rerank_f32": "fabstir_vectordb_tpu_torch/csrc/rerank_f32.cu",
    "merge_topk": "fabstir_vectordb_tpu_torch/csrc/merge_topk.cu",
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "pruned",
                                        "reduced"), default="all")
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
    if args.phase in ("all", "pruned", "reduced"):
        t = time.perf_counter()
        ctx = build_1m(torch, native, card, perf, launch_of)
        k7_checks(torch, ctx, results)
        for name in ("seed_pick", "seed_min_update", "seed_counts"):
            print_kernel(name, results[name], launch_of[name])
        print(f"1M build: {time.perf_counter() - t:.1f} s", flush=True)
        if args.phase != "reduced":
            t = time.perf_counter()
            pruned_phase(torch, native, card, perf, results, launch_of, ctx,
                         trace=args.trace, out_dir=args.out)
            print(f"pruned phase: {time.perf_counter() - t:.1f} s",
                  flush=True)
        if args.phase != "pruned":
            t = time.perf_counter()
            reduced_phase(torch, native, card, perf, results, launch_of, ctx,
                          trace=args.trace, out_dir=args.out)
            print(f"reduced phase: {time.perf_counter() - t:.1f} s",
                  flush=True)
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
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
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

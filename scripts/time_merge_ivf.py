#!/usr/bin/env python3
"""Time K15's shard merge and K12's list scan on one NVIDIA GPU.

    python scripts/time_merge_ivf.py [--root DIR] [--skip-merge] [--skip-ivf]
                                     [--out DIR]
    python scripts/time_merge_ivf.py --b1 [--root DIR]

``--root`` imports ``fabstir_vectordb_tpu_torch`` from another checkout
(an older tree unpacked under ``build/``), so two versions can be timed in
one call; its kernels build into that tree's own ``build/``.

The merge at the four shapes the parallel phase gives it (S = 4 shards:
search B=128 k_s=10, build B=1,024 k_s=200, projected B=128 k_s=2,048, IVF
B=128 k_s=10 through a row map), on seeded sorted lists with padding, a
lone -1 and ties, held to ``shard_merge_plain`` exactly; beside it
``torch.topk`` on the same [B, S k_s] matrix. Each is timed three ways:
device microseconds of one call (CUDA events around each call, queued
behind a sleep so no host gap falls inside), host microseconds of a call
(its launches queued, the card not waited for), and milliseconds of
back-to-back calls as chip_smoke.py's ``cuda_ms`` takes them.

K12 on a synthetic 1M-row index shaped like bench.py's 1M tier: 1,000,000
x 384 seeded Gaussian rows, 900K of them in 256 lists of lognormal lengths
(798-39,078 rows), each query probing 16 lists drawn with probability
rising with a list's length; B = 128 and B = 1, f32 and bf16 rows, each
route the tree has, with the device time of each stage (from
torch.profiler's kernel records, by kernel name), and the rows read as
modelled from the probes (list rows times query groups, not counted on
the card) beside the distinct probed rows. Results are held to
``ivf_scan_plain``.
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

HBM = 3.35e12
F32 = 67e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def stage_us(torch, fn, reps: int = 5) -> dict:
    """Device microseconds a K12 call ``fn`` spends in each stage, from
    torch.profiler's kernel records (means of ``reps`` calls): the work
    list (ivf_group_kernel), the list scan (ivf_tasks_kernel or
    ivf_scan_kernel) and the selection (every other kernel of the call)."""
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
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            stage = ("group" if "ivf_group_kernel" in e.name else
                     "scan" if "ivf_tasks_kernel" in e.name
                     or "ivf_scan_kernel" in e.name else "select")
            us[stage] += e.time_range.elapsed_us() / reps
    return us


def device_us(torch, fn, calls: int = 20) -> float:
    """Median device microseconds of one call, each between two events,
    all queued behind a sleep so the host never holds the card."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    torch.cuda._sleep(50_000_000)
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1]) * 1e3
                            for i in range(calls)]))


def host_us(torch, fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e6


def cuda_ms(torch, fn, iters: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timings(torch, fn) -> dict:
    return {"device_us": device_us(torch, fn), "host_us": host_us(torch, fn),
            "ms": cuda_ms(torch, fn)}


def merge_lists(torch, g, dev, s, b, ks):
    vals = torch.randn(s, b, ks, device=dev, generator=g) * 10
    vals[:, :, ::7] = vals[:, :, :1]
    vals, _ = torch.sort(vals, dim=-1)
    rows = torch.randint(0, 1 << 18, (s, b, ks), device=dev, generator=g,
                         dtype=torch.int32)
    pad = max(1, ks // 5)
    vals[:, 1::2, -pad:] = float("inf")
    rows[:, 1::2, -pad:] = -1
    rows[-1, 0, 0] = -1
    return vals.contiguous(), rows.contiguous()


def merge_part(torch, tp, dev) -> list:
    g = torch.Generator(device=dev).manual_seed(7)
    out = []
    for tag, b, ks, mapped in (("search", 128, 10, False),
                               ("build", 1024, 200, False),
                               ("projected", 128, 2048, False),
                               ("ivf", 128, 10, True)):
        s, k = 4, ks
        vals, rows = merge_lists(torch, g, dev, s, b, ks)
        base = torch.arange(s, dtype=torch.int32, device=dev) << 18
        row_map = (torch.randperm(s << 18, device=dev, generator=g)
                   .to(torch.int32) if mapped else None)
        vk, rk = tp.shard_merge(vals, rows, k, base=base, row_map=row_map)
        vp, rp = tp.shard_merge_plain(vals, rows, k, base=base,
                                      row_map=row_map)
        if not (torch.equal(rk, rp) and torch.equal(vk, vp)):
            raise SystemExit(f"shard_merge[{tag}] differs from the plain "
                             "version")
        flat = vals.permute(1, 0, 2).reshape(b, s * ks).contiguous()
        r = {"shape": tag, "S": s, "B": b, "k_s": ks, "k": k,
             "merge": timings(torch, lambda: tp.shard_merge(
                 vals, rows, k, base=base, row_map=row_map)),
             "topk": timings(torch, lambda: torch.topk(
                 flat, k, dim=1, largest=False))}
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


def host_parts(torch, tp, native, dev) -> dict:
    """Host microseconds of the parts of one merge call at the search
    shape (S=4, B=128, k_s=10), beside torch.topk's whole call."""
    g = torch.Generator(device=dev).manual_seed(3)
    s, b, ks, k = 4, 128, 10, 10
    vals, rows = merge_lists(torch, g, dev, s, b, ks)
    base = torch.arange(s, dtype=torch.int32, device=dev) << 18
    out = torch.empty((2, b, k), dtype=torch.float32, device=dev)
    words = (ctypes.c_longlong * 14)(
        vals.data_ptr(), rows.data_ptr(), base.data_ptr(), 0, s, b, ks, k, 0,
        0, 0, out[0].data_ptr(), out[1].data_ptr(), native.stream_of(vals))
    fn = native.fn("shard_merge", "fvdb_shard_merge_packed",
                   [ctypes.POINTER(ctypes.c_longlong)])
    flat = vals.permute(1, 0, 2).reshape(b, s * ks).contiguous()
    parts = {
        "wrapper": lambda: tp.shard_merge(vals, rows, k, base=base),
        "empty_2bk": lambda: torch.empty((2, b, k), dtype=torch.float32,
                                         device=dev),
        "two_empty": lambda: (torch.empty((b, k), dtype=torch.float32,
                                          device=dev),
                              torch.empty((b, k), dtype=torch.int32,
                                          device=dev)),
        "unbind_view": lambda: out.unbind(0)[1].view(torch.int32),
        "two_new_empty": lambda: (vals.new_empty((b, k)),
                                  rows.new_empty((b, k))),
        "ctypes_launch": lambda: fn(words),
        "data_ptrs": lambda: (vals.data_ptr(), rows.data_ptr(),
                              base.data_ptr(), out.data_ptr()),
        "stream": lambda: native.stream_of(vals),
        "topk": lambda: torch.topk(flat, k, dim=1, largest=False),
    }
    r = {name: host_us(torch, fn_, 2000) for name, fn_ in parts.items()}
    print(json.dumps({"host_parts_us": r}), flush=True)
    return r


def small_batches(torch, iv, dev, x, lens, lists, mask) -> list:
    """K12's two routes at small B (f32), device microseconds."""
    x_sq = (x * x).sum(1)
    g = torch.Generator(device=dev).manual_seed(11)
    out = []
    for b in (1, 2, 4, 8, 16, 32):
        _, pr = probes(torch, lens, b, 16, dev, seed=100 + b)
        q = torch.randn(b, 384, device=dev, generator=g)
        r = {"B": b}
        for route in (True, False):
            r["grouped" if route else "per-query"] = device_us(
                torch, lambda: iv.ivf_scan(x, x_sq, mask, lists, pr, q, 16,
                                           grouped=route))
        print(json.dumps({"small_b_us": r}), flush=True)
        out.append(r)
    return out


def synth_ivf(torch, iv, dev, n=1_000_000, d=384, c=256, seed=5):
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.normal(0.0, 1.0, c))
    lens = np.clip(lens / lens.sum() * 900_000, 798, 39_078).astype(np.int64)
    members = rng.permutation(n)[: lens.sum()]
    l_pad = 1 << int(np.ceil(np.log2(lens.max())))
    tiles = np.full((c, l_pad), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)])
    for i in range(c):  # rows in increasing order within a list
        tiles[i, : lens[i]] = np.sort(members[starts[i]: starts[i + 1]])
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g)
    cents = np.zeros((c, d), np.float32)
    lists = iv.IVFLists.upload(cents, tiles, dev)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[torch.from_numpy(members).to(dev)] = True
    return x, lens, lists, mask


def probes(torch, lens, b, p, dev, seed):
    rng = np.random.default_rng(seed)
    gum = -np.log(-np.log(rng.random((b, lens.size))))
    pr = np.argsort(-(np.log(lens)[None] + gum), 1)[:, :p]
    return pr, torch.from_numpy(pr.astype(np.int32)).to(dev)


def rows_read(lens, pr, qt):
    """List rows read: each probed list once a group of qt queries."""
    cnt = np.bincount(pr.ravel(), minlength=lens.size)
    groups = (cnt + qt - 1) // qt if qt else cnt
    return int((lens * groups).sum()), int(lens[cnt > 0].sum()), \
        int(lens[pr].sum())


def ivf_part(torch, iv, dev) -> dict:
    import inspect

    x, lens, lists, mask = synth_ivf(torch, iv, dev)
    x_sq = (x * x).sum(1)
    xb = x.to(torch.bfloat16)
    new = "grouped" in inspect.signature(iv.ivf_scan).parameters
    out = []
    g = torch.Generator(device=dev).manual_seed(9)
    for b in (128, 1):
        pr_np, pr = probes(torch, lens, b, 16, dev, seed=b)
        q = torch.randn(b, 384, device=dev, generator=g)
        read_g, distinct, pairs = rows_read(lens, pr_np, 32)
        for rows_t, tag in ((x, "f32"), (xb, "bf16")):
            routes = [None] if not new else [True, False]
            vp, rp = iv.ivf_scan_plain(rows_t, x_sq, mask, lists, pr, q, 16)
            for route in routes:
                kw = {} if route is None else {"grouped": route}
                vk, rk = iv.ivf_scan(rows_t, x_sq, mask, lists, pr, q, 16,
                                     **kw)
                fin = torch.isfinite(vp)
                err = float((vk - vp)[fin].abs().max())
                same = float((rk == rp).float().mean())
                elem = 2 if tag == "bf16" else 4
                r = {"B": b, "rows": tag,
                     "route": {None: "parent", True: "grouped",
                               False: "per-query"}[route],
                     "pairs": pairs, "distinct_rows": distinct,
                     "rows_read_modelled": read_g if route else pairs,
                     "bound_ms": max(distinct * 384 * elem / HBM,
                                     2.0 * pairs * 384 / F32) * 1e3,
                     "max_abs_err": err, "rows_equal_share": same,
                     "total": timings(torch, lambda: iv.ivf_scan(
                         rows_t, x_sq, mask, lists, pr, q, 16, **kw))}
                r["stage_us"] = stage_us(torch, lambda: iv.ivf_scan(
                    rows_t, x_sq, mask, lists, pr, q, 16, **kw))
                if err > 1e-2 or same < 0.99:
                    raise SystemExit(f"ivf_scan {r} off the plain version")
                print(json.dumps(r), flush=True)
                out.append(r)
    res = {"runs": out}
    if new:
        res["small_b"] = small_batches(torch, iv, dev, x, lens, lists, mask)
    return res


def b1_part(torch, iv, dev, tag: str) -> None:
    """K12 at B = 1 as a single pruned search gives it (the route the tree
    takes at B = 1), device microseconds of a call (median of 20), f32 and
    bf16 rows, on the synthetic 1M index, three queries."""
    x, lens, lists, mask = synth_ivf(torch, iv, dev)
    x_sq = (x * x).sum(1)
    xb = x.to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(9)
    for i in range(3):
        _, pr = probes(torch, lens, 1, 16, dev, seed=200 + i)
        q = torch.randn(1, 384, device=dev, generator=g)
        r = {"tree": tag, "query": i}
        for rows_t, name in ((x, "f32"), (xb, "bf16")):
            r[name] = device_us(torch, lambda: iv.ivf_scan(
                rows_t, x_sq, mask, lists, pr, q, 16))
        print(json.dumps({"b1_us": r}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--skip-ivf", action="store_true")
    ap.add_argument("--skip-merge", action="store_true")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the results' JSON file")
    ap.add_argument("--b1", action="store_true",
                    help="only K12 at B = 1 (f32 and bf16 rows), device "
                         "microseconds of a call, then exit")
    args = ap.parse_args()
    root = Path(args.root).resolve() if args.root else \
        Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    from fabstir_vectordb_tpu_torch.index import ivf as iv
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import native

    print(f"card: {card_line()}; tree: {root}", flush=True)
    t = native.build_all()
    for name in ("ivf_scan", "shard_merge"):
        for line in native.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"built in {t:.1f} s", flush=True)
    dev = torch.device("cuda")
    if args.b1:  # the tree is named by its directory: run two in turns
        b1_part(torch, iv, dev, root.name)
        return
    res = {}
    if not args.skip_merge:
        res["merge"] = merge_part(torch, tp, dev)
        res["host_parts"] = host_parts(torch, tp, native, dev)
    if not args.skip_ivf:
        res["ivf"] = ivf_part(torch, iv, dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"time_merge_ivf_{root.name}.json").write_text(
        json.dumps(res, indent=1))


if __name__ == "__main__":
    main()

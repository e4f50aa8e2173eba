#!/usr/bin/env python3
"""Time K1 and K9 over a bf16 serving mirror on one NVIDIA GPU.

    python scripts/time_bf16_tile.py [--root DIR] [--out DIR] [--iters N]

``--root`` imports ``fabstir_vectordb_tpu_torch`` from another checkout (an
older tree unpacked under ``build/``, e.g. ``git archive HEAD~``), so two
versions can be timed in one call, in turns (parent, change, change,
parent); its kernels build into that tree's own ``build/``.

The rows are 1,048,576 x 384 seeded Gaussian values rounded to bf16, with
the f32 rows' norms, 90% of them in a row mask, and seeded queries: the
bf16 serving mirror's shapes. Timed, with CUDA events over back-to-back
calls (as chip_smoke.py's ``cuda_ms``): K1 with the query rounded
(``ops.l2_topk(..., round_query=True)``) at B = 1 and 128 and k = 16, 64,
128 and 1,024, by cosine and dot at B = 128 and k = 16 and 1,024; the bf16
re-score composition (``fused.flat_search_rerank``: K1 to 128, K2 to 64);
K9 (``ops.approx_topk(..., round_query=True)``) at B = 1 and 128, ov_k =
128; and, as a yardstick of the tensor cores' rate that the port never
calls, one bf16 ``torch.matmul`` of the same [B, 384] x [384, N]. Each
result is held to its plain version on the same inputs (K1: sorted
distances within 1e-5 relative of the norms, rows equal but at ties; K9:
pools sharing >= 0.99 of their rows). Prints one JSON line and writes it
to ``--out``/time_bf16_tile_<tree>.json.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

N, D = 1_048_576, 384


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


def topk_err(vk, rk, vp, rp) -> tuple:
    """(max |distance difference| after sorting, queries whose rows
    differ): the rows may differ only where distances tie."""
    vk, rk, vp, rp = (t.cpu().numpy() for t in (vk, rk, vp, rp))
    ok, op = np.lexsort((rk, vk)), np.lexsort((rp, vp))
    vk, rk = np.take_along_axis(vk, ok, 1), np.take_along_axis(rk, ok, 1)
    vp, rp = np.take_along_axis(vp, op, 1), np.take_along_axis(rp, op, 1)
    fin = np.isfinite(vp)
    if not (np.isfinite(vk) == fin).all():
        raise SystemExit("padding differs from the plain version")
    err = float(np.abs(np.where(fin, vk - vp, 0.0)).max())
    return err, int((rk != rp).any(1).sum())


def overlap(rk, rp) -> float:
    rk, rp = rk.cpu().numpy(), rp.cpu().numpy()
    return float(np.mean([len(set(a[a >= 0].tolist())
                              & set(b[b >= 0].tolist()))
                          / max(int((b >= 0).sum()), 1)
                          for a, b in zip(rk, rp)]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the results' JSON file")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve() if args.root else \
        Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import native

    card = card_line()
    print(f"card: {card}; tree: {root}", flush=True)
    t = native.build_all()
    print(f"built in {t:.1f} s", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    xf = torch.randn(N, D, device=dev, generator=g)
    x_sq = (xf * xf).sum(1)
    x = xf.to(torch.bfloat16)
    del xf
    mask = torch.rand(N, device=dev, generator=g) < 0.9
    q128 = torch.randn(128, D, device=dev, generator=g)
    tol = 2e-5 * float(x_sq.max() + (q128 * q128).sum(1).max())
    res = {"card": card, "tree": root.name, "shape": f"N={N} D={D} bf16 "
           "rows, 90% masked in, the query rounded", "tol": tol}
    it = args.iters
    for _ in range(20):  # the card's clocks up before the first timing
        tp.l2_topk(x, x_sq, mask, q128, 16, round_query=True)
    torch.cuda.synchronize()

    def k1(b, k, metric="euclidean"):
        q = q128[:b].contiguous()
        def run():
            return tp.l2_topk(x, x_sq, mask, q, k, round_query=True,
                              metric=metric)
        vk, rk = run()
        vp, rp = tp.l2_topk_plain(x, x_sq, mask, q, k, round_query=True,
                                  metric=metric)
        err, differ = topk_err(vk, rk, vp, rp)
        if err > (1e-5 if metric == "cosine" else tol):
            raise SystemExit(f"K1 B={b} k={k} {metric}: max_abs_err {err}")
        return {"ms": cuda_ms(torch, run, it), "max_abs_err": err,
                "queries_differing_at_ties": differ}

    for b in (1, 128):
        for k in (16, 64, 128, 1024):
            res[f"k1 B={b} k={k}"] = k1(b, k)
            print(f"k1 B={b} k={k} {res[f'k1 B={b} k={k}']}", flush=True)
    for metric in ("cosine", "dot"):
        for k in (16, 1024):
            res[f"k1 {metric} B=128 k={k}"] = k1(128, k, metric)
    def rerank():
        return fu.flat_search_rerank(x, x_sq, mask, q128, 64, 128)

    vk, rk = rerank()
    vp, rp = fu.flat_search_rerank(x, x_sq, mask, q128, 64, 128, plain=True)
    err, differ = topk_err(vk, rk, vp, rp)
    res["k2 rest B=128 ov_k=128 m=64"] = {
        "ms": cuda_ms(torch, rerank, it), "max_abs_err": err,
        "queries_differing_at_ties": differ}
    for b in (1, 128):
        q = q128[:b].contiguous()
        def pool(q=q):
            return tp.approx_topk(x, x_sq, mask, q, 128, round_query=True)

        vk, rk = pool()
        vp, rp = tp.approx_topk_plain(x, x_sq, mask, q, 128, round_query=True)
        share = overlap(rk, rp)
        if share < 0.99:
            raise SystemExit(f"K9 B={b}: pools share {share} < 0.99")
        res[f"k9 B={b} ov_k=128"] = {"ms": cuda_ms(torch, pool, it),
                                     "pool_overlap_with_plain": share}
        qb = q.to(torch.bfloat16)
        res[f"gemm_ms B={b}"] = cuda_ms(
            torch, lambda: torch.matmul(qb, x.T), it)  # noqa: B023
    print(json.dumps(res), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"time_bf16_tile_{root.name}.json").write_text(
        json.dumps(res, indent=1))


if __name__ == "__main__":
    main()

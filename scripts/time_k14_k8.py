"""Time K14's projection (mirror rows and queries) and chunked_topk's step on
one NVIDIA GPU, each beside its plain version and one PyTorch call that
computes the same function, with the host time of a wrapper call.

    python scripts/time_k14_k8.py [--rows 524288] [--reps 20]

Shapes are chip_smoke.py's: a block of 524,288 bf16 rows at D = 384 into
rank 192 (centered, and off-center by three times the rows' spread), 128
queries, and 32 queries of negative dot distances over 8 chunks of 131,072
rows, masked, at k = 10 (the fused step) and k = 1,024 (mask pass, radix
select and merge). Prints one line per measurement and the card's name and
power limit; exits non-zero without a card or when a kernel disagrees with
its plain version.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from fabstir_vectordb_tpu_torch.index import fused as fu  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import topk as tp  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import native  # noqa: E402

BF16_FLOPS = 989e12  # H100 SXM dense bf16 (tensor cores)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
HBM = 3.35e12  # H100 SXM bytes/s


def ev_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def equal_share(yk, yp) -> float:
    return float((yk.float() == yp.float()).float().mean())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=524_288)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    native.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("project_rows", "merge_topk"):
        for line in native.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, d, r, reps = args.rows, 384, 192, args.reps
    p = torch.linalg.qr(torch.randn(d, r, device=dev, generator=g))[0]
    p = p.contiguous()
    for off in (0.0, 3.0):
        x = torch.randn(n, d, device=dev, generator=g)
        x += off * torch.randn(d, device=dev, generator=g)
        x = x.to(torch.bfloat16)
        mu = x[:65_536].float().mean(0)
        ok_, sk = torch.empty((n, r), dtype=torch.bfloat16, device=dev), \
            torch.empty(n, device=dev)
        op, sp = torch.empty_like(ok_), torch.empty_like(sk)
        fu.project_rows(x, mu, p, ok_, sk, 0)
        fu.project_rows_plain(x, mu, p, op, sp, 0)
        share = equal_share(ok_, op)
        ms = ev_ms(lambda: fu.project_rows(x, mu, p, ok_, sk, 0), reps)
        pms = ev_ms(lambda: fu.project_rows_plain(x, mu, p, op, sp, 0), 3)
        xc = x.float() - mu
        lms = ev_ms(lambda: torch.matmul(xc, p), reps)
        del xc
        bound = max(3 * 2.0 * n * d * r / BF16_FLOPS,
                    n * (2 * d + 2 * r + 4) / HBM) * 1e3
        print(f"project_rows n={n} D={d} r={r} off={off}: ms={ms:.4f} "
              f"plain_ms={pms:.4f} library_ms={lms:.4f} bound_ms="
              f"{bound:.4f} equal_share={share:.6f} ({card})", flush=True)
        if share < 0.999 and off == 0.0:
            sys.exit("project_rows: equal share under 0.999")
    q = torch.randn(128, d, device=dev, generator=g)
    pk, pp = fu.project_queries(q, mu, p), fu.project_queries_plain(q, mu, p)
    err = float((pk - pp).abs().max())
    if err > 1e-4 * float(pp.abs().max()):
        sys.exit(f"project_queries: max_abs_err {err}")
    qc = q - mu
    out = torch.empty((128, r), device=dev)
    fn = native.fn("project_rows", "fvdb_project_queries",
                   [native.P, native.I, native.I, native.P, native.P,
                    native.I, native.P, native.P])
    st = native.stream_of(q)

    def launch():
        return fn(q.data_ptr(), 128, d, mu.data_ptr(), p.data_ptr(), r,
                  out.data_ptr(), st)

    print(f"project_queries host parts: stream_of_us="
          f"{host_us(lambda: native.stream_of(q), 200):.2f} empty_us="
          f"{host_us(lambda: torch.empty((128, r), device=dev), 200):.2f} "
          f"ctypes_launch_us={host_us(launch, 200):.2f}", flush=True)
    plain_ms = ev_ms(lambda: fu.project_queries_plain(q, mu, p), 200)
    print(f"project_queries B=128 D={d} r={r}: ms="
          f"{ev_ms(lambda: fu.project_queries(q, mu, p), 200):.5f} "
          f"plain_ms={plain_ms:.5f} "
          f"library_ms={ev_ms(lambda: torch.matmul(qc, p), 200):.5f} "
          f"host_us={host_us(lambda: fu.project_queries(q, mu, p), 200):.2f} "
          f"max_abs_err={err} ({card})", flush=True)
    # chunked_topk: 32 queries, 8 chunks of 131,072 rows, dot, masked
    b, chunk = 32, 131_072
    nn = 8 * chunk
    xr = torch.randn(nn, d, device=dev, generator=g)
    qd = torch.randn(b, d, device=dev, generator=g)
    dall = torch.stack([-(qd @ xr[lo:lo + chunk].T)
                        for lo in range(0, nn, chunk)])
    keep = (torch.rand(nn, device=dev, generator=g) < 0.9).view(8, chunk)
    del xr

    def dist_fn(start):
        i = start // chunk
        return dall[i], keep[i]

    flat = torch.where(keep[:, None, :], dall,
                       torch.full_like(dall, float("inf"))
                       ).permute(1, 0, 2).reshape(b, nn).contiguous()
    # the fused step with no running list: its cost by k and input order
    d0, m0 = dall[0], keep[0]
    for k in (1, 10, 64, 256):
        rv = torch.full((b, k), float("inf"), device=dev)
        rr = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        o = (torch.empty_like(rv), torch.empty_like(rr))
        w = tp.chunk_scratch(b, chunk, k, dev)
        line = []
        for tag, dd, mm in (("random", d0, m0), ("nomask", d0, None),
                            ("ascending", d0.sort(1).values, None),
                            ("descending", d0.sort(1, descending=True).values,
                             None)):
            ms = ev_ms(lambda: tp.chunk_step(dd, mm, 0, rv, rr, k, o, w),
                       reps * 5)
            line.append(f"{tag}={ms:.4f}")
        print(f"chunk_step no running list B={b} C={chunk} k={k} ms: "
              + " ".join(line), flush=True)
    for k in (10, 1024):
        run = tp.chunked_topk(dist_fn, nn, chunk, k, b, device=dev)
        vk, rk = run()

        def plain_run():
            vals = torch.full((b, k), float("inf"), device=dev)
            rows = torch.full((b, k), -1, dtype=torch.int32, device=dev)
            for i in range(8):
                vals, rows = tp.chunk_step_plain(dall[i], keep[i], i * chunk,
                                                 vals, rows, k)
            return vals, rows

        vp, rp = plain_run()
        if not (torch.equal(rk, rp) and torch.equal(vk, vp)):
            bad = int((rk != rp).any(1).sum())
            sys.exit(f"chunked_topk k={k}: {bad} queries differ")
        run_v = torch.full((b, k), float("inf"), device=dev)
        run_r = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        outs = (torch.empty_like(run_v), torch.empty_like(run_r))
        work = tp.chunk_scratch(b, chunk, min(k, chunk), dev) \
            if k <= 256 else None
        step = (lambda: tp.chunk_step(dall[0], keep[0], 0, run_v, run_r, k,
                                      outs, work))
        # a step against the run's result: its bar drops almost every entry
        tight = (lambda: tp.chunk_step(dall[0], keep[0], 0, vk, rk, k, outs,
                                       work))
        print(f"chunked_topk B={b} N={nn} chunk={chunk} k={k}: ms="
              f"{ev_ms(run, reps):.4f} plain_ms={ev_ms(plain_run, 3):.4f} "
              f"library_ms="
              f"{ev_ms(lambda: torch.topk(flat, k, largest=False), reps):.4f}"
              f" step_ms={ev_ms(step, reps * 5):.4f} tight_step_ms="
              f"{ev_ms(tight, reps * 5):.4f} step_host_us="
              f"{host_us(step, reps * 5):.2f} bound_ms="
              f"{(b * nn * 4 + nn + b * k * 8) / HBM * 1e3:.4f} ({card})",
              flush=True)


if __name__ == "__main__":
    main()

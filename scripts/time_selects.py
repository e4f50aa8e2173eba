"""Time chunked_topk's step and masked_topk (B3) on one NVIDIA GPU, each
beside its plain version and ``torch.topk`` over the same masked matrix,
after holding each to its plain version exactly.

    python scripts/time_selects.py [--reps 20] [--profile] [--shared]

Shapes are chip_smoke.py's: 32 queries of negative dot distances over 8
chunks of 131,072 rows with a [C] mask, at k = 10 (the fused step), 300
and 1,024 (the filtered select), with each step's device time (the first
chunk apart) and the host time of a step; masked_topk over a [128,
1,048,576] matrix 90% masked in ([N] mask at k = 16 and 1,024, [B, N] mask
at k = 1,024) and over [128, 1,000] at k = 1,500. Prints one line per
measurement with the card's name and power limit; exits non-zero without a
card or when a kernel disagrees with its plain version. ``--profile``
adds torch.profiler's device time by kernel over a k = 1,024 run and each
masked_topk call. ``--shared`` times only the other callers of
csrc/topk_select.cuh's radix select at chip_smoke.py's shapes (K1 at k =
1,024 and 16,384 over 4 x 1,048,576 rows, B4 over [128, 1,048,576] at k =
128, the K15 merge at S = 4, B = 128, k_s = 2,048), through entry points
that every tree of the port has, so that two trees can be compared in
turns on one card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from fabstir_vectordb_tpu_torch.ops import topk as tp  # noqa: E402
from fabstir_vectordb_tpu_torch.utils import native  # noqa: E402

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


def device_us_each(fns) -> list:
    """Device microseconds of each call in turn, the card kept busy by a
    sleep while the host queues them all."""
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


def by_kernel(fn, tag: str) -> None:
    """Device microseconds by kernel name over one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us and e.key and not e.key.startswith(("aten::", "cuda")):
            rows.append((us, e.count, e.key))
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  profile {tag}: {key[:60]} x{count} {us:.1f} us", flush=True)


def shared(dev, g, reps: int, card: str) -> None:
    """The other radix-select callers, each checked against its plain
    version and timed."""
    n, d = 1_048_576, 384
    x = torch.randn(n, d, device=dev, generator=g)
    x_sq = (x * x).sum(1)
    mask = torch.rand(n, device=dev, generator=g) < 0.9
    q = torch.randn(4, d, device=dev, generator=g)
    for k in (1024, 16_384):
        vk, rk = tp.l2_topk(x, x_sq, mask, q, k)
        vp, _ = tp.l2_topk_plain(x, x_sq, mask, q, k)
        err = float((vk - vp).abs().max())
        print(f"shared l2_topk B=4 N={n} k={k}: ms="
              f"{ev_ms(lambda: tp.l2_topk(x, x_sq, mask, q, k), reps):.4f} "
              f"max_abs_err={err} ({card})", flush=True)
    del x, x_sq
    dm = torch.rand(128, n, device=dev, generator=g) * 100.0
    vk, rk = tp.masked_approx_topk(dm, mask, 128)
    vp, rp = tp.masked_approx_topk_plain(dm, mask, 128)
    print(f"shared masked_approx_topk B=128 N={n} k=128: ms="
          f"{ev_ms(lambda: tp.masked_approx_topk(dm, mask, 128), reps):.4f}"
          f" equal={bool(torch.equal(rk, rp) and torch.equal(vk, vp))} "
          f"({card})", flush=True)
    del dm
    sv = torch.rand(4, 128, 2048, device=dev, generator=g).sort(-1).values
    sr = torch.randint(0, 262_144, (4, 128, 2048), device=dev,
                       dtype=torch.int32, generator=g)
    base = torch.arange(4, device=dev, dtype=torch.int32) * 262_144
    vk, rk = tp.shard_merge(sv, sr, 2048, base)
    vp, rp = tp.shard_merge_plain(sv, sr, 2048, base)
    print(f"shared shard_merge S=4 B=128 k_s=2048: ms="
          f"{ev_ms(lambda: tp.shard_merge(sv, sr, 2048, base), reps):.4f} "
          f"equal={bool(torch.equal(rk, rp) and torch.equal(vk, vp))} "
          f"({card})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--shared", action="store_true")
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
    for line in native.build_log.get("merge_topk", "").splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            print(f"ptxas merge_topk: {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    reps = args.reps
    if args.shared:
        shared(dev, g, reps, card)
        return

    # chunked_topk: 32 queries, 8 chunks of 131,072 rows, dot, masked
    b, chunk, d = 32, 131_072, 384
    nn = 8 * chunk
    xr = torch.randn(nn, d, device=dev, generator=g)
    qd = torch.randn(b, d, device=dev, generator=g)
    dall = torch.stack([-(qd @ xr[lo:lo + chunk].T)
                        for lo in range(0, nn, chunk)])
    keep = (torch.rand(nn, device=dev, generator=g) < 0.9).view(8, chunk)
    del xr
    flat = torch.where(keep[:, None, :], dall,
                       torch.full_like(dall, float("inf"))
                       ).permute(1, 0, 2).reshape(b, nn).contiguous()

    def dist_fn(start):
        i = start // chunk
        return dall[i], keep[i]

    for k in (10, 300, 1024):
        run = tp.chunked_topk(dist_fn, nn, chunk, k, b, device=dev)
        before = native.launches["chunk_step"]
        vk, rk = run()
        calls = native.launches["chunk_step"] - before

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
        work = tp.chunk_scratch(b, chunk, min(k, chunk), dev, k)
        sv = [(torch.full((b, k), float("inf"), device=dev),
               torch.full((b, k), -1, dtype=torch.int32, device=dev))]
        sv.append((torch.empty_like(sv[0][0]), torch.empty_like(sv[0][1])))
        steps = [lambda i=i: tp.chunk_step(dall[i], keep[i], i * chunk,
                                           *sv[i % 2], k, sv[(i + 1) % 2],
                                           work) for i in range(8)]
        us = device_us_each(steps)
        step = (lambda: tp.chunk_step(dall[0], keep[0], 0, *sv[0], k, sv[1],
                                      work))
        print(f"chunked_topk B={b} N={nn} chunk={chunk} k={k}: ms="
              f"{ev_ms(run, reps):.4f} plain_ms={ev_ms(plain_run, 3):.4f} "
              f"library_ms="
              f"{ev_ms(lambda: torch.topk(flat, k, largest=False), reps):.4f}"
              f" step_device_us first={us[0]:.1f} then="
              + ",".join(f"{u:.1f}" for u in us[1:]) +
              f" step_host_us={host_us(step, reps * 5):.2f} "
              f"run_host_us={host_us(run, reps):.1f} calls={calls} bound_ms="
              f"{(b * nn * 4 + nn + b * k * 8) / HBM * 1e3:.4f} ({card})",
              flush=True)
        if args.profile and k > 256:
            by_kernel(run, f"chunked_topk k={k}")
    del dall, flat, keep

    # masked_topk (B3) over [128, 1M], 90% masked in, and [128, 1,000]
    b, n = 128, 1_048_576
    dm = torch.rand(b, n, device=dev, generator=g) * 100.0
    rmask = torch.rand(n, device=dev, generator=g) < 0.9
    qmask = torch.rand(b, n, device=dev, generator=g) < 0.9
    for tag, dd, mm, k in (("k=16", dm, rmask, 16),
                           ("k=1024", dm, rmask, 1_024),
                           ("k=1024 BxN mask", dm, qmask, 1_024),
                           ("k>N", dm[:, :1_000].contiguous(), None, 1_500)):
        vk, rk = tp.masked_topk(dd, mm, k)
        vp, rp = tp.masked_topk_plain(dd, mm, k)
        if not (torch.equal(rk, rp) and torch.equal(vk, vp)):
            sys.exit(f"masked_topk[{tag}]: differs from its plain version")
        src = torch.where(mm, dd, torch.full_like(dd, float("inf"))) \
            if mm is not None else dd
        kl = min(k, dd.shape[1])
        nbytes = dd.numel() * 4 + (mm.numel() if mm is not None else 0) \
            + b * k * 8
        print(f"masked_topk[{tag}] B={b} N={dd.shape[1]}: ms="
              f"{ev_ms(lambda: tp.masked_topk(dd, mm, k), reps):.4f} "
              f"plain_ms="
              f"{ev_ms(lambda: tp.masked_topk_plain(dd, mm, k), 3):.4f} "
              f"library_ms={ev_ms(lambda: torch.topk(src, kl, dim=1, largest=False), reps):.4f} "  # noqa: E501
              f"host_us={host_us(lambda: tp.masked_topk(dd, mm, k), reps):.1f}"
              f" bound_ms={nbytes / HBM * 1e3:.4f} device_us="
              f"{min(device_us_each([lambda: tp.masked_topk(dd, mm, k)] * 10)):.1f}"
              f" ({card})", flush=True)
        if args.profile:
            by_kernel(lambda: tp.masked_topk(dd, mm, k), f"masked_topk[{tag}]")
        del src
    # the host parts of a short call (k > N: one launch, no scratch)
    dd, k = dm[:, :1_000].contiguous(), 1_500
    od = torch.empty((b, k), device=dev)
    orr = torch.empty((b, k), dtype=torch.int32, device=dev)
    P, I, L = native.P, native.I, native.L
    fn = native.fn("merge_topk", "fvdb_masked_topk",
                   [P, P, L, I, I, I, P, L, P, P, P])
    st = native.stream_of(dd)
    parts = {
        "check": lambda: native.check(dd, "dists", torch.float32, 2,
                                      dd.device),
        "two_empty": lambda: (torch.empty((b, k), device=dev),
                              torch.empty((b, k), dtype=torch.int32,
                                          device=dev)),
        "stream_of": lambda: native.stream_of(dd),
        "data_ptr_x3": lambda: (dd.data_ptr(), od.data_ptr(),
                                orr.data_ptr()),
        "ctypes_launch": lambda: fn(dd.data_ptr(), 0, 0, b, 1_000, k, 0, 0,
                                    od.data_ptr(), orr.data_ptr(), st),
        "wrapper": lambda: tp.masked_topk(dd, None, k),
        "torch_topk": lambda: torch.topk(dd, 1_000, dim=1, largest=False),
    }
    print("masked_topk[k>N] host us: " + " ".join(
        f"{name}={host_us(f, 500):.2f}" for name, f in parts.items())
        + f" ({card})", flush=True)


if __name__ == "__main__":
    main()

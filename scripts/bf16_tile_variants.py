"""What bounds the tensor-core pass over a bf16 mirror (K1 and K9 with the
query rounded): time patched copies of
fabstir_vectordb_tpu_torch/csrc/bf16_tile.cuh, each without one part of
the work, on one NVIDIA GPU.

    python scripts/bf16_tile_variants.py                # every variant
    python scripts/bf16_tile_variants.py VARIANT ...    # some of them

Variants (the results are wrong on purpose; only the time is read):
  as_is        the pass as it stands
  x_from_l2    every block reads the same 1,024 rows (L2 hits): the pass
               without device-memory reads
  no_mma       no tensor-core products (the ring, the epilogue as is)
  no_offer     K1's lists: the distances formed, nothing offered to a list
  no_merge     K1's lists: offered against the bar, nothing passes it
  lists_w64    the plan's query width for K1's lists held to 64 (the
               source as it stands)
  merge_at_32  a query's staged keys merged only when its 32 slots are
               full (and at the slice's end); merge_at_1: every round
  stats        counters instead of a time, for one call of each K1 shape:
               merges and the keys they took, rounds of offers, keys
               staged, and the cycles the warps spent merging and the
               blocks spent in all (clock64)

Each patched copy of csrc/l2_topk.cu and csrc/approx_topk.cu is built with
the port's nvcc flags into build/bf16_tile_variants/ (all at once) and
timed at 1,048,576 x 384 bf16 rows, 90% in the mask: K1 at B = 1, k = 128
and B = 128, k = 16 / 128; K9 at B = 1 and 128, ov_k = 128; CUDA events
over 10 calls after a warm-up. Prints one line a variant and the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "as_is": [],
    "x_from_l2": [
        ("                    (g % KS) * SD, tile_row0(g / KS), "
         "full + slot);",
         "                    (g % KS) * SD, ((g / KS) % 8) * TC_ROWS,\n"
         "                    full + slot);"),
    ],
    "no_mma": [
        ("          Wgmma<QW>::mma(part, da + 2 * j, db + 2 * j, j);",
         "          if (da == 0) "
         "Wgmma<QW>::mma(part, da + 2 * j, db + 2 * j, j);"),
    ],
    "no_offer": [
        ("    } else {\n      // the bars all slices share",
         "    } else if (k < 0) {\n      // the bars all slices share"),
    ],
    "no_merge": [
        ("          if (key < bark[col]) {",
         "          if (key < bark[col] && k < 0) {"),
    ],
    "lists_w64": [],
    "merge_at_32": [("constexpr int TC_MERGE_AT = 16;",
                     "constexpr int TC_MERGE_AT = 32;")],
    "merge_at_1": [("constexpr int TC_MERGE_AT = 16;",
                    "constexpr int TC_MERGE_AT = 1;")],
    "stats": [
        ("namespace fvdb {\n",
         "namespace fvdb {\n__device__ unsigned long long g_stats[8];\n"),
        ("  const unsigned long long s = "
         "warp_sort(lane < m ? S[lane] : ~0ull);\n",
         "  if (lane == 0) atomicAdd(&g_stats[0], 1ull);\n"
         "  if (lane == 0) atomicAdd(&g_stats[2], (unsigned long long)m);\n"
         "  const unsigned long long s = "
         "warp_sort(lane < m ? S[lane] : ~0ull);\n"),
        ("            stg[col * TC_CAP + pos] = key;\n",
         "            stg[col * TC_CAP + pos] = key;\n"
         "            atomicAdd(&g_stats[5], 1ull);\n"),
        ("        int item = 0;\n",
         "        if (t == 0) atomicAdd(&g_stats[4], 1ull);\n"
         "        const long long c0 = clock64();\n        int item = 0;\n"),
        ("        if (!consumers_any(pend != 0)) break;",
         "        if (lane == 0) atomicAdd(&g_stats[6],"
         " (unsigned long long)(clock64() - c0));\n"
         "        if (!consumers_any(pend != 0)) break;"),
        ("  int g = 0;  // the block's step, as the producer counts them\n",
         "  const long long t_begin = clock64();\n"
         "  int g = 0;  // the block's step, as the producer counts them\n"),
        ("  if constexpr (MODE == SEL_BINS) {\n#pragma unroll\n"
         "    for (int i = 0; i < M; ++i) {\n"
         "      if (!(run[i] < INFINITY)) continue;",
         "  if (t == 0) atomicAdd(&g_stats[7],"
         " (unsigned long long)(clock64() - t_begin));\n"
         "  if constexpr (MODE == SEL_BINS) {\n#pragma unroll\n"
         "    for (int i = 0; i < M; ++i) {\n"
         "      if (!(run[i] < INFINITY)) continue;"),
    ],
}
STATS = ("merges", "-", "keys merged", "-",
         "offer rounds (blocks x rounds)", "keys staged",
         "merge cycles (warps)", "block cycles")
STATS_EXPORT = """
FVDB_EXPORT int fvdb_stats(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {};
    return (int)cudaMemcpyToSymbol(fvdb::g_stats, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(out, fvdb::g_stats, 8 * 8);
}
"""
SOURCES = ("l2_topk", "approx_topk")


def variant_dir(name: str) -> Path:
    return ROOT / "build" / "bf16_tile_variants" / name


def build_all(names):
    """The named variants' two libraries, one nvcc each, all at once."""
    from fabstir_vectordb_tpu_torch.utils import native

    procs = []
    for name in names:
        patches = VARIANTS[name]
        out = variant_dir(name)
        out.mkdir(parents=True, exist_ok=True)
        for hdr in native.CSRC.glob("*.cuh"):
            (out / hdr.name).write_text(hdr.read_text())
        tile = (out / "bf16_tile.cuh").read_text()
        for old, new in patches:
            if old not in tile:
                sys.exit(f"{name}: the source no longer holds {old!r}")
            tile = tile.replace(old, new)
        (out / "bf16_tile.cuh").write_text(tile)
        for src in SOURCES:
            text = (native.CSRC / f"{src}.cu").read_text()
            if name == "stats" and src == "l2_topk":
                text += STATS_EXPORT
            (out / f"{src}.cu").write_text(text)
            procs.append((name, src, subprocess.Popen(
                [native.nvcc(), *native.NVCC_FLAGS, "-o",
                 str(out / f"{src}.so"), str(out / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, src, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{name} {src}: nvcc failed\n{log}")


def time_variant(name: str) -> None:
    import torch

    from fabstir_vectordb_tpu_torch.ops import topk as tp
    from fabstir_vectordb_tpu_torch.utils import native

    for src in SOURCES:
        lib = ctypes.CDLL(str(variant_dir(name) / f"{src}.so"))
        lib.fvdb_error_string.restype = ctypes.c_char_p
        lib.fvdb_error_string.argtypes = [ctypes.c_int]
        native._libs[src] = lib  # the wrappers call this copy
    if name == "lists_w64":
        plan = tp.tile_plan

        def narrow(b, k, d, mode, route="wgmma"):
            return plan(min(b, 64), k, d, mode, route)._replace(
                tiles=-(-b // 64)) if mode == "lists" and b > 64 \
                else plan(b, k, d, mode, route)
        tp.tile_plan = narrow
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    xf = torch.randn(1_048_576, 384, device=dev, generator=g)
    x_sq = (xf * xf).sum(1)
    x = xf.to(torch.bfloat16)
    del xf
    mask = torch.rand(x.shape[0], device=dev, generator=g) < 0.9
    q128 = torch.randn(128, 384, device=dev, generator=g)
    out = []
    if name == "stats":
        stats = native._libs["l2_topk"].fvdb_stats
        stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for tag, b, k in (("k1 B=1 k=128", 1, 128), ("k1 B=128 k=16", 128, 16),
                          ("k1 B=128 k=128", 128, 128)):
            buf = (ctypes.c_ulonglong * 8)()
            torch.cuda.synchronize()
            stats(buf, 1)
            tp.l2_topk(x, x_sq, mask, q128[:b].contiguous(), k,
                       round_query=True)
            torch.cuda.synchronize()
            stats(buf, 0)
            print(f"bf16_tile stats {tag}: " + ", ".join(
                f"{what} {v}" for what, v in zip(STATS, buf)), flush=True)
        return
    for tag, fn in (
            ("k1 B=1 k=128", lambda: tp.l2_topk(
                x, x_sq, mask, q128[:1], 128, round_query=True)),
            ("k1 B=128 k=16", lambda: tp.l2_topk(
                x, x_sq, mask, q128, 16, round_query=True)),
            ("k1 B=128 k=128", lambda: tp.l2_topk(
                x, x_sq, mask, q128, 128, round_query=True)),
            ("k9 B=1", lambda: tp.approx_topk(
                x, x_sq, mask, q128[:1], 128, round_query=True)),
            ("k9 B=128", lambda: tp.approx_topk(
                x, x_sq, mask, q128, 128, round_query=True))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(f"{tag} {a.elapsed_time(b) / 10:.4f}")
    print(f"bf16_tile variant {name}: " + "; ".join(out) + " ms", flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--run"]:
        time_variant(sys.argv[2])
        return
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            sys.exit(f"unknown variant {name!r}: one of {list(VARIANTS)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build_all(names)
    for name in names:  # a process each: a fresh context per library
        r = subprocess.run([sys.executable, __file__, "--run", name])
        if r.returncode:
            sys.exit(r.returncode)


if __name__ == "__main__":
    main()

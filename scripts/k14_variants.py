"""What bounds K14's tensor-core projection: time patched copies of
fabstir_vectordb_tpu_torch/csrc/project_rows.cu, each without one part of
the work, on one NVIDIA GPU.

    python scripts/k14_variants.py            # every variant, one process each
    python scripts/k14_variants.py VARIANT    # one of them

Variants (the results are wrong on purpose; only the time is read):
  as_is       the kernel as it stands
  no_split    the split's tiles read only until the ring is full (no L2
              reads of P's split after that)
  x_from_l2   every block reads the same 256 rows of x (L2 hits)
  hi_only     only P_hi's products (a third of the tensor-core work)
  no_stores   the epilogue writes nothing but the norms
  step_promo  the sums promoted every 32-dim step instead of every window
  window_4    the sums promoted every 128 dims (4 steps) instead

Each copy is built with the port's nvcc flags into build/k14_variants/ and
timed at n = 524,288 bf16 rows, D = 384, r = 192 with CUDA events, 20
calls after a warm-up. Prints one line a variant and the card's name and
power limit.
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
    "no_split": [
        ("  mbar_expect(full + slot, mup_offset(NTILE) + (first ? NTILE * 4"
         " : 0));",
         "  mbar_expect(full + slot, (g >= S ? PA_BYTES : mup_offset(NTILE))"
         " + (first ? NTILE * 4 : 0));"),
        ("  for (int s = 0; s < 3; ++s)\n    tma_load_2d(",
         "  for (int s = 0; s < 3 && g < S; ++s)\n    tma_load_2d("),
    ],
    "x_from_l2": [
        ("  tma_load_2d(dst, tmx, d0, r0, full + slot);",
         "  tma_load_2d(dst, tmx, d0, 0, full + slot);"),
    ],
    "hi_only": [
        ("    for (int s = 2; s >= 0; --s)",
         "    for (int s = 0; s >= 0; --s)"),
        ("                            s < 2 || i > 0 || k16 > 0);",
         "                            i > 0 || k16 > 0);"),
    ],
    "no_stores": [
        ("          if (live && c < R)\n",
         "          if (live && c < R && R < 0)\n"),
        ("        if (!live || c >= R) continue;",
         "        if (!live || c >= R || R > 0) continue;"),
    ],
    "step_promo": [
        ("constexpr int PW = 2;", "constexpr int PW = 1;"),
    ],
    "window_4": [
        ("constexpr int PW = 2;", "constexpr int PW = 4;"),
    ],
}


def build(name: str) -> Path:
    from fabstir_vectordb_tpu_torch.utils import native

    src = (native.CSRC / "project_rows.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            sys.exit(f"{name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / "k14_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"project_rows_{name}.cu"
    cu.write_text(src.replace('#include "', f'#include "{native.CSRC}/'))
    so = out / f"project_rows_{name}.so"
    r = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    return so


def time_variant(name: str) -> None:
    import torch

    from fabstir_vectordb_tpu_torch.index import fused as fu
    from fabstir_vectordb_tpu_torch.utils import native

    lib = ctypes.CDLL(str(build(name)))
    lib.fvdb_error_string.restype = ctypes.c_char_p
    lib.fvdb_error_string.argtypes = [ctypes.c_int]
    native._libs["project_rows"] = lib  # the wrapper calls this copy
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, d, r = 524_288, 384, 192
    x = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
    mu = x[:65_536].float().mean(0)
    p = torch.linalg.qr(torch.randn(d, r, device=dev, generator=g))[0]
    p = p.contiguous()
    out = torch.empty((n, r), dtype=torch.bfloat16, device=dev)
    sq = torch.empty(n, device=dev)
    fu.project_rows(x, mu, p, out, sq, 0)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        fu.project_rows(x, mu, p, out, sq, 0)
    b.record()
    torch.cuda.synchronize()
    print(f"k14 variant {name}: {a.elapsed_time(b) / 20:.4f} ms", flush=True)


def main() -> None:
    if len(sys.argv) > 1:
        time_variant(sys.argv[1])
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    for name in VARIANTS:  # a process each: a fresh context per library
        r = subprocess.run([sys.executable, __file__, name])
        if r.returncode:
            sys.exit(r.returncode)


if __name__ == "__main__":
    main()

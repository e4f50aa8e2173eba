"""Device choice and the f32 precision policy of the port.

Entry points take ``device=None``, which means the card. Without one they
raise: the CPU is used only when a caller asks for it (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        set_f32_precision()
    return dev


def set_f32_precision() -> None:
    """Full f32 products on the card: no TF32 anywhere. The reference asks
    for Precision.HIGHEST on its f32 distance products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

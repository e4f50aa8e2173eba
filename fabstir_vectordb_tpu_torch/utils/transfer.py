"""Host <-> device copies: uploads through pinned memory, bf16 uploads that
never hold a bf16 host copy, and readbacks that wait once for several
results."""
from __future__ import annotations

import numpy as np
import torch


def to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a numpy array. On the card it goes through a pinned staging
    copy with ``non_blocking=True``, so the copy engine moves it while the
    host goes on; the caching host allocator keeps the staging buffer alive
    until the copy is done. On the CPU the result shares no memory with
    ``host`` (later host writes must not reach a snapshot)."""
    host = np.ascontiguousarray(host)
    if not host.flags.writeable:  # torch wants writable memory to wrap
        host = host.copy()
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def put_bf16_blocks(src: np.ndarray, n_rows: int, device: torch.device,
                    block_bytes: int = 256 << 20) -> torch.Tensor:
    """The first ``n_rows`` rows of ``src`` as an [n_rows, dim] bf16 device
    tensor, uploaded ~``block_bytes`` of f32 at a time through pinned memory
    and cast (round to nearest even) into the preallocated tensor in place:
    neither a bf16 host copy nor a full f32 device copy is ever held."""
    n_rows, dim = int(n_rows), int(src.shape[1])
    rows_per = max(int(block_bytes) // (dim * 4), 1)
    mirror = torch.empty((n_rows, dim), dtype=torch.bfloat16, device=device)
    for lo in range(0, n_rows, rows_per):
        hi = min(lo + rows_per, n_rows)
        mirror[lo:hi].copy_(to_device(np.asarray(src[lo:hi], np.float32),
                                      device))
    return mirror


def to_host(*tensors: torch.Tensor) -> tuple:
    """Device tensors -> numpy arrays. On the card every copy is queued
    (into pinned memory, ``non_blocking=True``) before one wait on the
    stream, instead of one round trip per tensor."""
    if not tensors or tensors[0].device.type != "cuda":
        return tuple(t.numpy() for t in tensors)
    out = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(t.numpy() for t in out)

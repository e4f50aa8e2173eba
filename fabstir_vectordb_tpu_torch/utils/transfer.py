"""Host <-> device copies: uploads through pinned memory, and readbacks that
wait once for several results."""
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


def to_host(*tensors: torch.Tensor) -> tuple:
    """Device tensors -> numpy arrays. On the card every copy is queued
    (into pinned memory, ``non_blocking=True``) before one wait on the
    stream, instead of one round trip per tensor."""
    if not tensors or tensors[0].device.type != "cuda":
        return tuple(t.numpy() for t in tensors)
    out = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(t.numpy() for t in out)

"""Process-wide forward-progress hook (a copy of the JAX package's
``utils/progress.py``).

Long-running build stages call :func:`mark` as they complete sub-steps; a
harness that watches for stalls registers a callback with
:func:`set_hook`. Everything else pays one attribute load and a None check.
"""
from __future__ import annotations

from typing import Callable, Optional

_hook: Optional[Callable[[], None]] = None


def set_hook(fn: Optional[Callable[[], None]]) -> None:
    global _hook
    _hook = fn


def mark() -> None:
    if _hook is not None:
        _hook()

"""Parameters rounded to a compute dtype once (``cast_once``), for
``nn/precision.py``'s layers and for ``utils/graphs.py``'s captured
programs, which keep their rounded weights from their warm-up runs on.
It imports no layer: a deploy CLI that captures an exported program
loads no model code."""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Dict, Optional

import torch

__all__ = ["cast", "cast_once", "casts_once"]

# the rounded parameters of the outermost ``cast_once`` block the calling
# thread is in, or None (a context variable, as autograd's modes are
# thread-local)
_CASTS: contextvars.ContextVar[Optional[Dict[tuple, torch.Tensor]]] = \
    contextvars.ContextVar("parakeet_tpu_torch_casts", default=None)


@contextlib.contextmanager
def cast_once(casts: Optional[Dict[tuple, torch.Tensor]] = None):
    """Within the block, each parameter is rounded to a dtype once (see
    ``nn/precision.py``'s doc); blocks nest into the outermost one.
    ``casts``, a dict the caller keeps, holds the rounded copies past the
    block: a block given one uses it whether or not it is nested, so that
    the next block given the same dict reuses them."""
    if casts is not None:
        token = _CASTS.set(casts)
    else:
        token = _CASTS.set({}) if _CASTS.get() is None else None
    try:
        yield
    finally:
        if token is not None:
            _CASTS.reset(token)


def casts_once(fn: Callable) -> Callable:
    """``fn`` run inside ``cast_once`` (for a method with a step loop)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with cast_once():
            return fn(*args, **kwargs)
    return wrapped


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``, a parameter's made once inside ``cast_once``."""
    casts = _CASTS.get()
    if (casts is None or t.dtype == dtype
            or not isinstance(t, torch.nn.Parameter)):
        return t.to(dtype)
    key = (id(t), dtype, torch.is_grad_enabled())
    if key not in casts:
        casts[key] = t.to(dtype)
    return casts[key]

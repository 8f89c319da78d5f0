"""The card's routes for the dry run's fake tensors.

The dry run (``launch.dryrun``) traces a step on ``FakeTensor``s:
nothing is allocated and no kernel launches. A fake tensor on the card
(``is_cuda``) takes the card's routes, as a real one does. PyTorch built
without CUDA cannot record autograd on a fake CUDA tensor (autograd
asks for the CUDA device guard that such a build lacks, and the process
aborts), so the dry run traces the card's step on fake CPU tensors
inside :func:`card_trace`, where a fake tensor on any device takes every
route a CUDA tensor takes: flash attention in the model, ``torch.exp``
in ``numerics.exp_stable``, and each kernel wrapper's ``"fake"`` route,
which allocates what the CUDA route allocates, launches nothing and
passes the launch to :func:`note_launch`'s listeners (the roofline
analyzer, ``launch.hlo_analysis.Analyzer``, listens while it traces). A
real tensor never takes a fake route, inside :func:`card_trace` or out
of it.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List

import torch

_DEPTH = [0]
_LOCK = threading.Lock()
_LISTENERS: List[Callable[..., None]] = []


@contextmanager
def card_trace():
    """Fake tensors take the card's routes inside (process-wide: the
    autograd engine may run a backward on another thread)."""
    with _LOCK:
        _DEPTH[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _DEPTH[0] -= 1


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def fake_route(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper takes its fake route for ``t``: a fake
    tensor on the card, or any fake tensor inside :func:`card_trace`."""
    return is_fake(t) and (t.is_cuda or _DEPTH[0] > 0)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's routes: a CUDA tensor, or a fake
    tensor that :func:`fake_route` sends there."""
    return t.is_cuda or fake_route(t)


@contextmanager
def launches_to(listener: Callable[..., None]):
    """``listener(kernel, plain, dims)`` is called inside for every fake
    launch (process-wide, as :func:`card_trace`)."""
    with _LOCK:
        _LISTENERS.append(listener)
    try:
        yield
    finally:
        with _LOCK:
            _LISTENERS.remove(listener)


def note_launch(kernel: str, plain, **dims) -> None:
    """A kernel wrapper's fake route: one launch of ``kernel`` at these
    dims, whose plain version is ``plain`` (a ``functools.partial`` over
    the launch's inputs, not called here), passed to every listener
    (nothing outside one)."""
    with _LOCK:
        listeners = list(_LISTENERS)
    for listener in listeners:
        listener(kernel, plain, dims)

"""Spans and counters inside the port, recorded under ``torch.profiler``.

The port's one home for tracing.  ``span(name)`` marks a stretch of host
work, ``count(name, n)`` adds to a counter.  Both do work only while a
``torch.profiler`` session records on this process: the gate is the
profiler's own enabled flag, and the port has no switch of its own.  Off,
``span`` returns one shared no-op context (``OFF``) and ``count`` returns
at once: one flag check a site.

On, a span enters ``torch.profiler.record_function("xrspatial.<name>")``,
so it lies on the profiler's timeline, on the device trace's clock, under
whatever span the caller opened; and it appends a ``Span`` to a bounded
ring (the last ``RING`` spans): its start and end on the host clock
(``time.perf_counter``), the index of the enclosing span and its request,
the sequence number of the outermost span it lies in, shared by every
span inside that one.  The one exception to the gate is the kernel
library's set-up (``setup.library``, ``setup.build`` inside it when the
library was stale), once a process: recorded whatever the flag says.

The spans, at the boundaries of the port's layers:

- ``api.<op>``: a public op (``terrain_pipeline``, ``focal_stats``,
  ``viewshed`` on its XDraw routes, ``binary``, ``proximity``,
  ``allocation``, ``direction``); ``api.args``: its argument checks,
  footprint, resolution, coordinate reads, the viewpoint's snapping and
  the payload; ``api.dataset``: the DataArrays and the Dataset of its
  result;
- ``torchops.<pass>``: the host issuing an op's passes of torch ops
  (no kernel of the port's own): ``viewshed_fields`` and
  ``viewshed_epilogue`` (XDraw's slope fields, and its inward max,
  visibility and angles, on its torch-op route: a raster off the card),
  ``binary`` (the classes), ``proximity_mask``
  (the target mask and the rounds' seed state) and
  ``proximity_epilogue`` (the state's decode, the distance and the
  result's mask);
- ``dispatch.surface``, ``dispatch.focal``: from the route choice to the
  last launch's return (plans, outputs, the launch; on a mesh the loop
  over blocks, each block's own dispatch span inside);
  ``dispatch.xdraw``: XDraw's plan and the launch of its scans (the twin
  on the CPU); ``dispatch.viewshed_fields`` and
  ``dispatch.viewshed_epilogue``: the launches of XDraw's fields and
  epilogue kernels on the card (one a raster, or one a block of a mesh);
  ``dispatch.jfa``: the jump flood's loop of rounds;
- ``mesh.halo_extend``: issuing one halo exchange's fills and copies
  (an in-place stencil's: its bands' strips);
- ``viewshed_exact.<phase>``: the exact viewshed's phases (the exact
  route's roots: no ``api.viewshed`` around them);
- ``setup.library``, ``setup.build``: the library's hash, build and load.

The counters: ``mesh.halo_ops`` (the fills and copies a halo exchange, an
in-place stencil's bands or a strip layout issues), ``mesh.halo_bytes``
(the bytes they write), ``mesh.inplace_blocks`` and
``mesh.extended_blocks`` (the blocks of each mesh stencil, by the route it
took), ``xdraw.cells_kernel`` and ``xdraw.cells_torchops`` (one a
raster, or a block of a mesh, whose XDraw fields and epilogue ran as the
card's kernels or as torch ops), and ``host.syncs``: one for each call at
which the host waits on the card on the paths of XDraw's viewshed and of
the proximity family (a blocking copy from the host,
``kernels/viewshed.py::_f32`` and ``.to`` of a host array; a read back,
``.item()`` and ``.cpu()``), counted on any device, so a run on the CPU
counts what the same route waits for on the card.  XDraw's kernel route
on the card passes its scalars as arguments and waits for nothing; its
torch-op route, which the CPU runs, counts its nine waits.

Read with ``spans()`` and ``counters()``; ``clear()`` empties both.  The
profiler's Chrome trace (``export_chrome_trace``) is the export.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

__all__ = ["Span", "span", "count", "on", "spans", "counters", "clear",
           "OFF", "PREFIX", "RING"]

PREFIX = "xrspatial."
RING = 1 << 15          # spans kept, the newest

# True while a torch.profiler session records on this process
on = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    index: int          # the span's sequence number in this process
    name: str
    t0: float           # host clock (time.perf_counter), s
    t1: float
    parent: int         # the enclosing span's index; -1 at a root
    request: int        # the sequence number of the root span


class _Off:
    """The shared context of every span while the profiler is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()

_ring: deque = deque(maxlen=RING)
_counters: dict = {}
_lock = threading.Lock()
_open = threading.local()       # this thread's open spans, innermost last
_indices = itertools.count()
_requests = itertools.count()


class _On:
    __slots__ = ("name", "index", "parent", "request", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.index = next(_indices)
        if stack:
            self.parent, self.request = stack[-1].index, stack[-1].request
        else:
            self.parent, self.request = -1, next(_requests)
        stack.append(self)
        self.rf = None
        if on():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        _ring.append(Span(self.index, self.name, self.t0, t1, self.parent,
                          self.request))
        return False


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


def span(name: str, always: bool = False):
    """A context marking the host work inside it as span `name`; while the
    profiler is off (and not `always`) the shared no-op ``OFF``."""
    if always or on():
        return _On(name)
    return OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while the profiler records."""
    if on():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def spans() -> list:
    """The recorded spans still in the ring, in the order they ended."""
    return list(_ring)


def counters() -> dict:
    """Every counter's total since the last ``clear``."""
    with _lock:
        return dict(_counters)


def clear() -> None:
    """Empty the ring and the counters."""
    _ring.clear()
    with _lock:
        _counters.clear()

"""The port's own spans and counters in a traced run.

While ``torch.profiler`` records, the port (``xrspatial_torch.tracing``)
keeps a span at each boundary of its layers (``api.*``, ``dispatch.*``,
``mesh.*``) and counters of the halo exchange (``mesh.halo_ops``,
``mesh.halo_bytes``), on the host clock (``time.perf_counter``) that the
benchmark's ``Job`` records share; the set-up span ``setup.library`` is
kept whether or not the profiler runs.  The per-layer metrics
``metrics/<name>.py`` read them here:

- ``spans``: the port's spans of the traced jobs, those of the requests
  whose root lies inside a traced job's call;
- ``self_ms``: a span's time less its children's, summed over the spans
  a name selects, ms a traced job;
- ``idle_ms``: the cards' idle time (the mean over the cards) while the
  host's innermost port span is one a name selects, ms a traced job: the
  port's spans are put on the trace's clock by ``offset``;
- ``per_job``: a counter a traced job;
- ``setup_s``: the first ``setup.library`` span, s.

A name ending in ``.`` selects every span it begins (``"dispatch."``),
any other name only itself.  Each returns None where the port has no
tracing module (a checkout that predates it) or recorded nothing there.
"""

from __future__ import annotations

import importlib
from bisect import bisect_right
from statistics import median

from gpubench.trace import API

PORT_TRACING = "xrspatial_torch.tracing"


def tracing():
    """The port's tracing module, or None."""
    try:
        return importlib.import_module(PORT_TRACING)
    except ImportError:
        return None


def _traced_jobs(ctx) -> list:
    return [j for j in ctx.jobs if j.traced]


def _jobs(ctx) -> int:
    t = ctx.trace
    return t.jobs if t is not None else 0


def _selects(name: str, key: str) -> bool:
    return name.startswith(key) if key.endswith(".") else name == key


def spans(ctx) -> list:
    """The port's spans of the traced jobs (``tracing.Span`` s), or None."""
    mod = tracing()
    jobs = sorted(_traced_jobs(ctx), key=lambda j: j.issue)
    if mod is None or not jobs:
        return None
    issues = [j.issue for j in jobs]
    every = mod.spans()
    keep = set()
    for s in every:
        if s.parent != -1:
            continue
        k = bisect_right(issues, s.t0) - 1
        if k >= 0 and s.t1 <= jobs[k].ret:
            keep.add(s.request)
    return [s for s in every if s.request in keep] or None


def self_intervals(spans, key: str) -> list:
    """The stretches ``(t0, t1)`` of host clock in which a span `key`
    selects is the innermost of `spans`, sorted."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.t0, s.t1))
    out = []
    for s in spans:
        if not _selects(s.name, key):
            continue
        t = s.t0
        for a, b in sorted(kids.get(s.index, [])):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if s.t1 > t:
            out.append((t, s.t1))
    return sorted(out)


def self_ms(ctx, key: str):
    """The self time of the spans `key` selects, ms a traced job."""
    ss = spans(ctx)
    n = _jobs(ctx)
    if not ss or not n:
        return None
    if not any(_selects(s.name, key) for s in ss):
        return None
    return sum(b - a for a, b in self_intervals(ss, key)) / n * 1e3


def offsets(ctx) -> list:
    """For each traced job, its ``gpubench.api`` span's midpoint on the
    trace's clock less its call's midpoint on the host clock (both clocks
    hold that span), in order; None where the two counts differ."""
    t = ctx.trace
    jobs = _traced_jobs(ctx)
    if t is None or not jobs:
        return None
    api = [(a, b) for n, a, b in t.spans if n == API]
    if len(api) != len(jobs):
        return None
    return [(a + b) / 2 - (j.issue + j.ret) / 2
            for (a, b), j in zip(api, jobs)]


def offset(ctx):
    """The trace's clock less the host clock: the median of ``offsets``."""
    offs = offsets(ctx)
    return median(offs) if offs else None


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, k = 0.0, 0, 0
    while i < len(xs) and k < len(ys):
        a, b = xs[i]
        c, d = ys[k]
        part = min(b, d) - max(a, c)
        if part > 0:
            total += part
        if b < d:
            i += 1
        else:
            k += 1
    return total


def idle_ms(ctx, key: str):
    """The cards' idle time (the mean over the cards) while the host's
    innermost port span is one `key` selects, ms a traced job."""
    ss = spans(ctx)
    off = offset(ctx)
    n = _jobs(ctx)
    if not ss or off is None or not n:
        return None
    mine = [(a + off, b + off) for a, b in self_intervals(ss, key)]
    if not mine:
        return None
    t = ctx.trace
    idle = sum(_overlap(mine, t.gaps(d)) for d in range(t.cards)) / t.cards
    return idle / n * 1e3


def per_job(ctx, counter: str):
    """Counter `counter` a traced job (it counts only while the profiler
    records: the traced stretch)."""
    mod = tracing()
    n = _jobs(ctx)
    if mod is None or not n:
        return None
    v = mod.counters().get(counter)
    return v / n if v else None


def setup_s(ctx):
    """The kernel library's set-up (hash, build if stale, load), s."""
    mod = tracing()
    if mod is None:
        return None
    lib = [s for s in mod.spans() if s.name == "setup.library"]
    if not lib:
        return None
    first = min(lib, key=lambda s: s.t0)
    return first.t1 - first.t0

"""The device timeline of a traced stretch of jobs, from ``torch.profiler``.

The benchmark's own spans (``torch.profiler.record_function``) mark the
traced window (``gpubench.window``) and, for each job, the call into the
port (``gpubench.api``), the wait for every card (``gpubench.sync``) and
the drop of its outputs (``gpubench.drop``).  The profiler's Chrome trace
gives every kernel, copy and fill on each card, on the same clock as the
spans.  Everything is clipped to the traced window.
"""

from __future__ import annotations

import json
import re
import shutil
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW, API, SYNC, DROP = ("gpubench.window", "gpubench.api",
                           "gpubench.sync", "gpubench.drop")
HOST_SPANS = (API, SYNC, DROP)
BETWEEN = "gpubench.between_jobs"


def start(cuda: bool):
    """Start the profiler (CPU activity for the spans, CUDA for the
    cards)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.start()
    return prof


def warm(cuda: bool):
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, seconds on the card) falls in the run's set-up and not in the
    window."""
    import torch
    prof = start(cuda)
    torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
    if cuda:
        torch.cuda.synchronize()
    prof.stop()


def stop(prof, cards: int) -> "Trace":
    """Stop the profiler and read its trace (written to a scratch folder
    under ``TMPDIR`` and removed)."""
    prof.stop()
    tmp = tempfile.mkdtemp(prefix="gpubench-trace-")
    try:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            return Trace.from_chrome(json.load(f), cards)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Trace:
    """Device events ``(cat, name, device, t0, t1)`` and host spans
    ``(name, t0, t1)``, in seconds, within the traced window."""

    def __init__(self, events, spans, cards: int):
        wins = [(a, b) for n, a, b in spans if n == WINDOW]
        if not wins:
            raise ValueError("the trace has no gpubench.window span")
        self.w0, self.w1 = wins[0]
        self.cards = cards
        self.events = [(c, n, d, max(a, self.w0), min(b, self.w1))
                       for c, n, d, a, b in events
                       if b > self.w0 and a < self.w1]
        self.spans = sorted(((n, a, b) for n, a, b in spans
                             if n in HOST_SPANS and b > self.w0
                             and a < self.w1), key=lambda s: s[1])
        self.jobs = sum(1 for n, a, _ in self.spans if n == API)

    @classmethod
    def from_chrome(cls, data: dict, cards: int) -> "Trace":
        events, spans = [], []
        for ev in data.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            t0 = float(ev["ts"]) * 1e-6
            t1 = t0 + float(ev.get("dur", 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                dev = ev.get("args", {}).get("device", ev.get("pid"))
                dev = int(re.sub(r"\D", "", str(dev)) or 0)
                events.append((cat, str(ev["name"]), dev, t0, t1))
            elif cat == "user_annotation" and \
                    str(ev["name"]).startswith("gpubench."):
                spans.append((str(ev["name"]), t0, t1))
        return cls(events, spans, cards)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def intervals(self, dev) -> list:
        """The merged intervals in which something ran on card `dev`."""
        out = []
        for a, b in sorted((a, b) for _, _, d, a, b in self.events
                           if d == dev and b > a):
            if out and a <= out[-1][1] + 1e-9:    # 1 ns: the clock's step
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self, dev) -> float:
        return sum(b - a for a, b in self.intervals(dev))

    def busiest(self) -> int:
        return max(range(self.cards), key=self.busy_s)

    def total_s(self, dev, keep) -> float:
        """Seconds of card `dev`'s events with ``keep(cat, name)``."""
        return sum(b - a for c, n, d, a, b in self.events
                   if d == dev and keep(c, n))

    def gaps(self, dev) -> list:
        """Card `dev`'s idle stretches ``(t0, t1)`` in the window."""
        out, t = [], self.w0
        for a, b in self.intervals(dev):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def idle_by_span(self, dev) -> dict:
        """Card `dev`'s idle seconds by the benchmark span the host was in
        (``gpubench.between_jobs`` outside every span)."""
        out = {}
        for a, b in self.gaps(dev):
            rest = b - a
            for n, s0, s1 in self.spans:
                part = min(b, s1) - max(a, s0)
                if part > 0:
                    out[n] = out.get(n, 0.0) + part
                    rest -= part
            if rest > 1e-12:
                out[BETWEEN] = out.get(BETWEEN, 0.0) + rest
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (seconds summed over
        the cards) and the idle time by the host's span (seconds, the
        mean over the cards)."""
        ops = {}
        for _, n, _, a, b in self.events:
            k = short_name(n)
            ops[k] = ops.get(k, 0.0) + (b - a)
        idle = {}
        for dev in range(self.cards):
            for k, v in self.idle_by_span(dev).items():
                idle[k] = idle.get(k, 0.0) + v / self.cards
        best = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in best],
                "idle_gaps": [[k, v] for k, v in
                              sorted(idle.items(), key=lambda kv: -kv[1])
                              [:top]]}


def short_name(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces
    and its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(")[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return head[:120] or name[:120]


def base_name(name: str) -> str:
    """A kernel's own identifier: ``void ns::kern<...>(...)`` gives
    ``kern``."""
    name = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[(<]", name, maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else ""


def port_kernels(port_dir) -> frozenset:
    """The names of the port's hand-written kernels: every ``__global__``
    function of its ``csrc/*.cu``."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    names = set()
    for src in sorted(Path(port_dir, "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return frozenset(names)

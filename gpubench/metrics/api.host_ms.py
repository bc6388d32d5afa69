"""api.host_ms: the benchmark's span from the call into the port to its
return, before the sync; the mean over the jobs of the window that ran
outside the profiler."""

from gpubench.stats import mean


def read(ctx):
    xs = [j.ret - j.issue for j in ctx.jobs if j.ok and not j.traced]
    return mean(xs) * 1e3 if xs else None

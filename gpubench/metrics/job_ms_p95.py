"""job_ms_p95: the 95th percentile (nearest rank) of every completed
job's latency in the window: the host clock from issuing the job to its
result being complete on every card of the cell."""

from gpubench.stats import percentile


def read(ctx):
    lat = [j.done - j.issue for j in ctx.jobs if j.ok]
    return percentile(lat, 95) * 1e3 if lat else None

"""api.host_syncs: the port's counter ``host.syncs`` (each call at which
the host waits on the card: a blocking copy from the host, a read back to
it) a traced job."""

from gpubench import portspans


def read(ctx):
    return portspans.per_job(ctx, "host.syncs")

"""mesh.halo_ops: the fills and copies the halo exchanges issue (the port's
counter ``mesh.halo_ops``), on all the cards, a traced job."""

from gpubench import portspans


def read(ctx):
    return portspans.per_job(ctx, "mesh.halo_ops")

"""mesh.halo_gib: the bytes the halo exchanges' fills and copies write
(the port's counter ``mesh.halo_bytes``), on all the cards, GiB a traced
job."""

from gpubench import portspans


def read(ctx):
    v = portspans.per_job(ctx, "mesh.halo_bytes")
    return v / 2 ** 30 if v is not None else None

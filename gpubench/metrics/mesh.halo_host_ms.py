"""mesh.halo_host_ms: the host time of the port's ``mesh.halo_extend``
spans (issuing each halo exchange's fills and copies), ms a traced job."""

from gpubench import portspans


def read(ctx):
    return portspans.self_ms(ctx, "mesh.halo_extend")

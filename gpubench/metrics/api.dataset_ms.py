"""api.dataset_ms: the self time of the port's ``api.dataset`` spans (the
result's DataArrays and Dataset), ms a traced job."""

from gpubench import portspans


def read(ctx):
    return portspans.self_ms(ctx, "api.dataset")

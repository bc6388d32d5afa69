"""setup.library_s: the port's span around its kernel library's set-up
(the sources' hash, the build where the library is stale, the load), in
seconds; the port records it once a process, with or without a profiler."""

from gpubench import portspans


def read(ctx):
    return portspans.setup_s(ctx)

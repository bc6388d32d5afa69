"""mpix_s: DEM pixels of every job completed in the window over the
window's seconds (from the first job's issue to the last one's
completion), in millions a second."""


def read(ctx):
    done = [j for j in ctx.jobs if j.ok]
    if not done or not ctx.window_s:
        return None
    return len(done) * ctx.pixels / ctx.window_s / 1e6

"""The check of a global job: a chain of whole-raster steps (a viewshed,
a classification of it, distances to its classes, say), each computed by
its op's plain reference over the whole raster, the last step's planes
compared with the program's.

The DEM is put together from the benchmark's own blocks on the first
block's device, in float64, with the configuration's coordinates
(``dem.coords``: float64 tensors on that device, or None where the
configuration states none); a chain whose working set would not fit in
that device's free memory is refused.  Each step's ``reference/<op>.py``
runs in turn on the raster its ``input`` names (``dem``, or an earlier
step's ``name``), with its drawn args as the reference sees them.  The
last step's planes are compared with the program's, every cell, block by
block on the first block's device, with the stencil check's numbers:
``nan_mismatch`` and ``<plane>_err``, the widest gap between finite
values over the largest |reference|.  The control runs the same chain in
a lower dtype.

A step's reference module has

- ``planes(args)``: the names of the planes of its op's result.  A step
  whose result is one plane passes it on to the steps that name it, and
  at the end of the chain it is compared under the step's ``name``, as
  the harness names an unnamed result (so an op that names its result
  ends a chain only under a step ``name`` equal to that name);
- ``run(raster, coords, args, dtype)``: ``{plane: tensor}`` over the
  whole raster, computed in `dtype` from `raster` (its input, a tensor
  in `dtype` on the device) and `coords` (``(y, x)`` in float64, or
  None), with ``args`` as ``jobs.reference_args`` makes them.
"""

from __future__ import annotations

import torch

from gpubench import dem as demlib
from gpubench.checks import stencil

numbers = stencil.numbers

# float64 planes a reference may hold beside the DEM and the steps'
# outputs while it computes
WORK_PLANES = 6


def planes(job) -> list:
    """The planes compared: the last step's, a single one under the
    step's name."""
    names = job[-1].reference.planes(job[-1].args)
    return [job[-1].name] if len(names) == 1 else list(names)


def fits(config, job, device) -> None:
    """Refuse a chain whose float64 planes (the DEM, one output a step and
    ``WORK_PLANES``) would not fit in `device`'s free memory; a CPU
    device is not measured."""
    if device.type != "cuda":
        return
    ny, nx = config["shape"]
    need = 8 * ny * nx * (1 + len(job) + WORK_PLANES)
    free, _ = torch.cuda.mem_get_info(device)
    # blocks torch's allocator holds but no tensor uses are free to it too
    free += torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)
    if need > free:
        raise MemoryError(f"the chain's {need} bytes do not fit in the "
                          f"{free} free on {device}")


def run_chain(job, dem, coords, dtype) -> dict:
    """The last step's planes of `job` from the whole DEM `dem`, each
    step's reference in `dtype`."""
    env = {"dem": dem.to(dtype)}
    for k, step in enumerate(job):
        out = step.reference.run(env[step.input], coords, step.args, dtype)
        if len(out) == 1:
            (value,) = out.values()
            out = {step.name: value}
        if k == len(job) - 1:
            return out
        if len(out) != 1:
            raise ValueError(f"step {step.name!r} gives {len(out)} planes: "
                             "only a job's last step may give more than "
                             "one")
        env[step.name] = out[step.name]
    raise ValueError("a job of no steps")


def gaps(config, blocks, job, judged) -> dict:
    """Per plane ``(widest gap, largest |reference|, NaN mismatches)`` of
    the last step of `job` (``jobs.Step``s).

    ``judged(i, j, dem, coords)`` gives the judged planes of block (i, j),
    as a dict of tensors of the block's extent (`dem` and `coords` are the
    whole DEM in float64 and its coordinates, for a control that computes
    from them).
    """
    dev = blocks[0][0].device
    fits(config, job, dev)
    ny, nx = config["shape"]
    dem = stencil.dem_window(blocks, config, (0, ny), (0, nx), dev)
    yx = demlib.coords(config)
    coords = None if yx is None else tuple(
        torch.from_numpy(c).to(dev) for c in yx)
    ref = run_chain(job, dem, coords, torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    acc = {p: [zero, zero, zero.to(torch.int64)] for p in planes(job)}
    for i, row in enumerate(blocks):
        for j in range(len(row)):
            (y0, y1), (x0, x1) = demlib.block_extents(config, i, j)
            got = judged(i, j, dem, coords)
            for p, a in acc.items():
                stencil.fold(a, ref[p][y0:y1, x0:x1],
                             got[p].to(device=dev, dtype=torch.float64), zero)
            del got
    return stencil.merge({dev: acc})


def program(planes, config):
    """`judged` for the program's output: `planes` maps a plane name to
    its grid of blocks (``[[tensor]]``, block (i, j) of the DEM block's
    extent)."""
    def judged(i, j, dem, coords):
        return {p: grid[i][j] for p, grid in planes.items()}
    return judged


def control(job, config, dtype):
    """`judged` for the control: the same chain of references in
    `dtype`, computed once."""
    made = {}

    def judged(i, j, dem, coords):
        if not made:
            made.update(run_chain(job, dem, coords, dtype))
        (y0, y1), (x0, x1) = demlib.block_extents(config, i, j)
        return {p: v[y0:y1, x0:x1] for p, v in made.items()}
    return judged

"""A group of small-stride jump-flood rounds in one kernel launch.

Counterpart of the TPU probe ``tools/exp_jfa_fixed.py::multi_round_fixed``:
the strides ``ks`` (H = sum(ks)) run over one window of (T+2H)^2 cells a
block, whose T x T centre is the output (``csrc/jfa_group.cu``, wrapper
``cuda_jfa_group.py``).  The result equals the round kernel applied round
by round over the same strides, bit for bit, so the plain versions here
loop the round twins of ``jfa_rounds``.  Both state forms of the round
kernel, every metric of each, and no value plane (as in the TPU probe).

Shared memory is what limits a group: a block holds its window twice (the
round-start values and the round's output), 4 bytes a cell a plane, and
may use 227 KB (``SHARED_BYTES``).  ``window_plan`` takes the largest T of
``TILES`` whose window fits and raises ``ValueError``, naming the bytes,
for a group whose window fits at no T: the TPU probe's group (64, 32, 16,
8, 4, 2, 1, 2, 1), H = 130, is one.  Proximity's 16384^2 schedule ends
with ``TAIL`` (H = 34), which fits at T = 64 packed.

``group_packed`` and ``group_coords`` dispatch: a tensor on the CPU goes
to the twin, a tensor on the card to the kernel; both refuse a group that
the kernel cannot take.
"""

from __future__ import annotations

from .jfa_rounds import EUCLIDEAN, GREAT_CIRCLE, MANHATTAN
from .jfa_rounds import round_coords, round_packed

__all__ = ["TILES", "SHARED_BYTES", "MAX_ROUNDS", "TAIL", "window_plan",
           "group_packed_twin", "group_coords_twin", "group_packed",
           "group_coords"]

TILES = (128, 64, 32, 16, 8)     # output tile edges T, largest first
SHARED_BYTES = 232448            # shared memory a block may opt in to
MAX_ROUNDS = 16                  # strides a launch takes (csrc/jfa_group.cu)
# the last 7 rounds of proximity's schedule at 16384^2
TAIL = (16, 8, 4, 2, 1, 2, 1)


def window_plan(ks, form: str) -> tuple:
    """(T, H, shared bytes) of the group `ks` in `form` ("packed": one
    int32 plane, "coords": two float32 planes).  Raises ValueError for a
    bad group, or one whose double-buffered window fits at no T."""
    ks = tuple(int(k) for k in ks)
    if not ks or len(ks) > MAX_ROUNDS or min(ks) < 1:
        raise ValueError(f"a group is 1 to {MAX_ROUNDS} strides >= 1, got "
                         f"{ks}")
    if form not in ("packed", "coords"):
        raise ValueError(f"form is 'packed' or 'coords', got {form!r}")
    planes = 1 if form == "packed" else 2
    h = sum(ks)
    for t in TILES:
        nbytes = 2 * planes * 4 * (t + 2 * h) ** 2
        if nbytes <= SHARED_BYTES:
            return t, h, nbytes
    need = 2 * planes * 4 * (TILES[-1] + 2 * h) ** 2
    raise ValueError(
        f"the {form} window of group {ks} (H = {h}) needs {need} bytes of "
        f"shared memory at T = {TILES[-1]}, more than the {SHARED_BYTES} a "
        f"block may use")


def group_packed_twin(state, ks, metric: int, steps):
    """The rounds `ks` over the packed int32 state, one round twin at a
    time; returns the new state."""
    for k in ks:
        state, _, _ = round_packed(state, None, int(k), metric, steps)
    return state


def group_coords_twin(tx, ty, xs, ys, ks, metric: int):
    """The rounds `ks` over the float32 coordinate state; returns (tx,
    ty)."""
    for k in ks:
        tx, ty, _ = round_coords(tx, ty, None, xs, ys, int(k), metric)
    return tx, ty


def _check_metric(form, metric):
    allowed = (EUCLIDEAN, MANHATTAN) if form == "packed" else (
        EUCLIDEAN, GREAT_CIRCLE, MANHATTAN)
    if metric not in allowed:
        raise ValueError(f"the {form} state takes metrics {allowed}, got "
                         f"{metric}")


def group_packed(state, ks, metric: int, steps):
    """The group `ks` over the packed state on its device."""
    window_plan(ks, "packed")
    _check_metric("packed", metric)
    if state.device.type == "cpu":
        return group_packed_twin(state, ks, metric, steps)
    from .cuda_jfa_group import group_packed_cuda
    return group_packed_cuda(state, ks, metric, steps)


def group_coords(tx, ty, xs, ys, ks, metric: int):
    """The group `ks` over the coordinate state on its device."""
    window_plan(ks, "coords")
    _check_metric("coords", metric)
    if tx.device.type == "cpu":
        return group_coords_twin(tx, ty, xs, ys, ks, metric)
    from .cuda_jfa_group import group_coords_cuda
    return group_coords_cuda(tx, ty, xs, ys, ks, metric)

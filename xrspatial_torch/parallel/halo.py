"""Halo-exchange engine: a raster in blocks over a 2D grid of devices.

Counterpart of ``xrspatial_tpu/parallel/halo.py``.  The JAX package shards
a raster over a ``Mesh(('y', 'x'))`` and runs each stencil under
``shard_map``, its halos sent by ``ppermute``.  Here one process drives
the mesh, as one JAX controller does:

- ``RasterMesh`` is a 2D grid of ``torch.device`` s; a device may appear
  more than once, which is how a mesh of several blocks is built on one
  CPU or one card (the JAX tests' forced host devices);
- ``ShardedRaster`` is the one global raster: its shape and dtype, its
  mesh and a grid of per-device blocks;
- a halo strip is a copy between two blocks' devices
  (``Tensor.copy_(..., non_blocking=True)``), made outside any kernel:
  a copy within one device when the blocks share it, a peer copy between
  cards otherwise.  ``copy_`` across cards orders itself after the work
  queued on the source's current stream and before the work queued next
  on the destination's, so a strip is read only after the kernel that
  wrote it, with no ``synchronize``.

``torch.distributed`` is not used: it runs one process per rank, which
would change the contract that one call takes one global raster and
returns one, and NCCL refuses two ranks on one card.

The layout.  Along a mesh axis of m devices a raster of n cells is either
split into tiles of ``t = ceil(n / m)`` cells, tile i holding the cells
``[i*t, min((i+1)*t, n))`` (the last tiles may be shorter, or empty), or
replicated: every block along that axis holds all n.  ``distribute``
splits an axis that divides its mesh axis and replicates one that does
not, with the JAX package's warning; the stencil outputs are split on
both axes.

The exchange (``halo_extend``) is the JAX package's two-phase one: each
block is first extended in x from its row of blocks, then the extended
rows in y from its column of blocks, which carries the corners with no
diagonal copy.  A halo wider than a tile gathers from as many tiles as
it covers (the multi-hop gather), and the cells beyond the raster take
``fill`` (NaN, the reference's ``boundary=np.nan``; the jump flood's
packed state passes -1).  Every extended block has the full tile's
shape, so a short last tile is padded with ``fill`` as the JAX dispatch
pads the raster to the mesh's tile grid, and each extended row is
rounded up to 16 bytes with more fill: the staged CUDA kernels take TMA
only on 16-byte rows, and those columns feed only the ring that is
cropped.

A stencil (``stencil_shard_map``) takes one of two routes, chosen from
the shapes it is given.  In place, where every tile holds its halo four
times over (``inplace_fits``) and the kernel is window-local: the kernel
runs on each tile as it lies, which gets every cell at least the radius
from the tile's edge right, and then on two small bands a block
(``_bands``: the tile's edge strips with the halo strips around them,
gathered from the neighbouring tiles, `fill` beyond the raster), whose
outputs rebuild the tile's edge ring; no tile is copied.  Extended,
otherwise (a halo wider than a quarter tile, a kernel whose output
depends on more than its window, or one that takes its block's
origin): each tile is copied into its ``halo_extend`` block and the
kernel's output cropped.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import tracing

__all__ = [
    "HaloSpec", "RasterMesh", "ShardedRaster", "RasterSharding",
    "make_raster_mesh", "raster_sharding", "distribute", "halo_extend",
    "stencil_shard_map", "get_raster_mesh", "tiles", "tile_size",
    "tile_extent", "shifted_blocks", "zip_blocks", "ROW_ALIGN_BYTES",
    "flat_devices", "to_strips", "from_strips", "inplace_fits",
    "BAND_SLACK",
]

# an extended block's rows are rounded up to this many bytes (TMA's rule)
ROW_ALIGN_BYTES = 16
# columns of fill a band carries past its cells: a CPU vector loop ends
# each pass on a scalar path (the last elements short of two 16-lane
# float32 vectors), whose atan2 may round otherwise, so a band's kept
# cells stay clear of every pass's end, as a whole raster's cells do
BAND_SLACK = 32


@dataclass(frozen=True)
class HaloSpec:
    """Halo radius per spatial axis (rows, cols)."""
    ry: int
    rx: int

    @classmethod
    def square(cls, r: int) -> "HaloSpec":
        return cls(r, r)


class RasterMesh:
    """A 2D ('y', 'x') grid of torch devices."""

    axis_names = ("y", "x")

    def __init__(self, devices):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a raster mesh needs a non-empty rectangular "
                             "grid of devices")
        self.devices = grid

    @property
    def shape(self) -> dict:
        return {"y": len(self.devices), "x": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    def __repr__(self) -> str:
        return (f"RasterMesh({self.shape['y']}x{self.shape['x']}, "
                f"{[str(d) for row in self.devices for d in row]})")


class RasterSharding(NamedTuple):
    """The block layout of a raster over a mesh: the counterpart of a
    ``NamedSharding``; `spec` names the mesh axis each dim is split over
    (None: not split, held whole by every block)."""
    mesh: RasterMesh
    spec: tuple


def make_raster_mesh(n_y: Optional[int] = None, n_x: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> RasterMesh:
    """A 2D ('y', 'x') mesh over `devices`, by default every visible card.

    With neither `n_y` nor `n_x` the factorisation is the square-ish one
    of the JAX package.  Without a card the default raises: a mesh on the
    CPU is asked for by name, ``devices=[torch.device("cpu")] * n``.
    """
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "make_raster_mesh: no CUDA device is visible; pass "
                "devices=[torch.device('cpu')] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_y is None and n_x is None:
        n_y = int(np.floor(np.sqrt(n)))
        while n % n_y:
            n_y -= 1
        n_x = n // n_y
    elif n_y is None:
        n_y = n // n_x
    elif n_x is None:
        n_x = n // n_y
    if n_y * n_x > n or n_y < 1 or n_x < 1:
        raise ValueError(f"mesh {n_y}x{n_x} needs more than {n} devices")
    return RasterMesh([devices[i * n_x:(i + 1) * n_x] for i in range(n_y)])


def raster_sharding(mesh: RasterMesh, ndim: int = 2) -> RasterSharding:
    """The layout placing the trailing (y, x) dims over the mesh."""
    return RasterSharding(mesh, (None,) * (ndim - 2) + ("y", "x"))


def tile_size(n: int, m: int) -> int:
    """Cells of a tile when n cells are split over m blocks."""
    return -(-n // m)


def tile_extent(n: int, m: int, i: int) -> tuple:
    """(start, stop) of tile i of n cells split over m blocks."""
    t = tile_size(n, m)
    return min(i * t, n), min((i + 1) * t, n)


class ShardedRaster:
    """One global raster held as a grid of blocks over a ``RasterMesh``.

    ``blocks[i][j]`` lies on ``mesh.device(i, j)``; `split` says per
    spatial axis (y, x) whether the blocks split it into tiles or each
    holds it whole.  Leading dims (a stats axis) are held whole by every
    block, and so are the `trail` dims after the spatial ones (0 but for
    a composite's trailing band).  Built by ``distribute`` and by the
    ops' mesh branches.
    """

    __slots__ = ("blocks", "shape", "mesh", "split", "trail")

    def __init__(self, blocks, shape, mesh: RasterMesh, split, trail=0):
        self.blocks = tuple(tuple(row) for row in blocks)
        self.shape = tuple(int(s) for s in shape)
        self.mesh = mesh
        self.split = (bool(split[0]), bool(split[1]))
        self.trail = int(trail)
        ny, nx = mesh.shape["y"], mesh.shape["x"]
        if len(self.blocks) != ny or any(len(r) != nx for r in self.blocks):
            raise ValueError(f"a {ny}x{nx} mesh needs {ny}x{nx} blocks")
        for i in range(ny):
            for j in range(nx):
                b = self.blocks[i][j]
                (y0, y1), (x0, x1) = self.extent(0, i), self.extent(1, j)
                want = self._shape_of(y1 - y0, x1 - x0)
                if tuple(b.shape) != want or b.device != mesh.device(i, j):
                    raise ValueError(
                        f"block ({i}, {j}) is {tuple(b.shape)} on "
                        f"{b.device}; the layout needs {want} on "
                        f"{mesh.device(i, j)}")

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spatial(self) -> tuple:
        """The (y, x) extent of the whole raster."""
        a = self.ndim - 2 - self.trail
        return self.shape[a:a + 2]

    def _shape_of(self, h: int, w: int) -> tuple:
        """The shape with the spatial dims (h, w)."""
        a = self.ndim - 2 - self.trail
        return self.shape[:a] + (h, w) + self.shape[a + 2:]

    def index_of(self, rows: slice, cols: slice) -> tuple:
        """The index of the spatial window (rows, cols), every other dim
        whole."""
        return (Ellipsis, rows, cols) + (slice(None),) * self.trail

    def extent(self, axis: int, i: int) -> tuple:
        """(start, stop) of the cells block index i holds along spatial
        `axis` (0: y, 1: x)."""
        n = self.spatial[axis]
        if not self.split[axis]:
            return 0, n
        return tile_extent(n, (self.mesh.shape["y"], self.mesh.shape["x"])
                           [axis], i)

    def gather(self, device=None) -> torch.Tensor:
        """The whole raster as one tensor on `device` (the first block's
        device by default): an explicit copy of every block."""
        dev = self.blocks[0][0].device if device is None \
            else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        ny, nx = len(self.blocks), len(self.blocks[0])
        for i in range(ny if self.split[0] else 1):
            for j in range(nx if self.split[1] else 1):
                y0, y1 = self.extent(0, i)
                x0, x1 = self.extent(1, j)
                out[self.index_of(slice(y0, y1), slice(x0, x1))].copy_(
                    self.blocks[i][j])
        return out

    def __getitem__(self, key) -> torch.Tensor:
        """A window of the raster, ``x[rows, cols]`` with two slices of
        step 1 over the spatial dims, as one tensor on the first block's
        device: a copy of the pieces of the blocks it overlaps (the whole
        raster for ``x[:, :]``, as ``gather``)."""
        if not (isinstance(key, tuple) and len(key) == 2
                and all(isinstance(k, slice) and k.step in (None, 1)
                        for k in key)):
            raise TypeError("a ShardedRaster takes a window of two slices "
                            "of step 1")
        h, w = self.spatial
        (r0, r1, _), (c0, c1, _) = key[0].indices(h), key[1].indices(w)
        r1, c1 = max(r1, r0), max(c1, c0)
        out = torch.empty(self._shape_of(r1 - r0, c1 - c0),
                          dtype=self.dtype, device=self.blocks[0][0].device)
        ny, nx = len(self.blocks), len(self.blocks[0])
        for i in range(ny if self.split[0] else 1):
            y0, y1 = self.extent(0, i)
            a, b = max(y0, r0), min(y1, r1)
            for j in range(nx if self.split[1] else 1):
                x0, x1 = self.extent(1, j)
                c, d = max(x0, c0), min(x1, c1)
                if a < b and c < d:
                    out[self.index_of(slice(a - r0, b - r0),
                                      slice(c - c0, d - c0))].copy_(
                        self.blocks[i][j][self.index_of(
                            slice(a - y0, b - y0), slice(c - x0, d - x0))])
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.gather("cpu").numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def copy(self) -> "ShardedRaster":
        """A deep copy, block for block."""
        return self.map_blocks(torch.clone)

    def map_blocks(self, fn: Callable) -> "ShardedRaster":
        """A raster of the same layout holding ``fn(block)`` for each block
        (`fn` keeps the spatial dims and the trailing ones; it may change
        the dtype and the leading dims)."""
        blocks = [[fn(b) for b in row] for row in self.blocks]
        return _grid_of(blocks, self, self.trail)

    def __repr__(self) -> str:
        return (f"ShardedRaster(shape={self.shape}, dtype={self.dtype}, "
                f"split={self.split}, mesh={self.mesh!r})")


def _grid_of(blocks, x: ShardedRaster, trail: int) -> ShardedRaster:
    """The raster of `blocks` in `x`'s layout, `trail` dims after the
    spatial ones."""
    b = blocks[0][0].shape
    a = len(b) - 2 - trail
    return ShardedRaster(blocks, tuple(b[:a]) + x.spatial + tuple(b[a + 2:]),
                         x.mesh, x.split, trail)


def zip_blocks(fn: Callable, *rasters: ShardedRaster,
               trail: int = 0) -> ShardedRaster:
    """A raster holding ``fn(i, j, *blocks)`` for the blocks (i, j) of
    `rasters`, which share one layout; the result takes the first's, with
    `trail` dims of `fn`'s blocks after the spatial ones."""
    x = rasters[0]
    for r in rasters[1:]:
        if r.mesh is not x.mesh or r.split != x.split \
                or r.spatial != x.spatial:
            raise ValueError("zip_blocks takes rasters of one layout")
    blocks = [[fn(i, j, *(r.blocks[i][j] for r in rasters))
               for j in range(len(row))] for i, row in enumerate(x.blocks)]
    return _grid_of(blocks, x, trail)


def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `t` on `device`."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t, non_blocking=True)
    return out


def distribute(data, mesh: RasterMesh) -> ShardedRaster:
    """Place an array (a tensor, a numpy array or a DataArray payload) on
    the mesh, its trailing (y, x) dims in blocks.

    A dim that divides its mesh axis is split into equal tiles; one that
    does not is held whole by every block along that axis (replicated),
    with a warning, as in the JAX package.
    """
    if isinstance(data, ShardedRaster):
        data = data.gather()
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.require(np.asarray(data),
                                           requirements="W"))
    shape = tuple(data.shape)
    split = (shape[-2] % mesh.shape["y"] == 0,
             shape[-1] % mesh.shape["x"] == 0)
    for ax, s, size in (("y", split[0], shape[-2]),
                        ("x", split[1], shape[-1])):
        if not s and mesh.shape[ax] > 1:
            warnings.warn(
                f"distribute: dim of size {size} does not divide the mesh "
                f"'{ax}' axis ({mesh.shape[ax]} devices); that dim is "
                "REPLICATED, not sharded. Pad the raster to a multiple of "
                "the mesh shape to distribute it.",
                UserWarning, stacklevel=2)
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    ys = [tile_extent(shape[-2], ny, i) if split[0] else (0, shape[-2])
          for i in range(ny)]
    xs = [tile_extent(shape[-1], nx, j) if split[1] else (0, shape[-1])
          for j in range(nx)]
    blocks = [[_copy_to(data[..., ys[i][0]:ys[i][1], xs[j][0]:xs[j][1]],
                        mesh.device(i, j)) for j in range(nx)]
              for i in range(ny)]
    return ShardedRaster(blocks, shape, mesh, split)


def get_raster_mesh(arr) -> Optional[RasterMesh]:
    """The mesh `arr` is split over, or None: for anything but a
    ``ShardedRaster``, for a mesh of one device and for a raster that no
    block splits (each block holds all of it).  Ops call this to choose
    between the single-device path and the mesh branch."""
    if not isinstance(arr, ShardedRaster):
        return None
    if arr.mesh.size <= 1 or not any(arr.split):
        return None
    return arr.mesh


def tiles(x: ShardedRaster) -> ShardedRaster:
    """`x` split on both axes: a replicated axis is cut into tiles where
    each block already holds it (no copy between devices)."""
    if all(x.split):
        return x
    ny, nx = x.mesh.shape["y"], x.mesh.shape["x"]
    h, w = x.shape[-2:]
    blocks = []
    for i in range(ny):
        row = []
        for j in range(nx):
            b = x.blocks[i][j]
            if not x.split[0]:
                y0, y1 = tile_extent(h, ny, i)
                b = b[..., y0:y1, :]
            if not x.split[1]:
                x0, x1 = tile_extent(w, nx, j)
                b = b[..., x0:x1]
            row.append(b.contiguous())
        blocks.append(row)
    return ShardedRaster(blocks, x.shape, x.mesh, (True, True))


def _sources(n: int, m: int, g0: int, g1: int):
    """The tiles holding cells [g0, g1) of n split over m, clipped to
    [0, n): (tile, local start, local stop, offset from g0) each."""
    t = tile_size(n, m)
    out = []
    a = max(g0, 0)
    b = min(g1, n)
    while a < b:
        i = a // t
        stop = min(b, (i + 1) * t)
        out.append((i, a - i * t, stop - i * t, a - g0))
        a = stop
    return out


def _written(t: torch.Tensor) -> None:
    """Count one fill or copy of an exchange that wrote `t`, and its bytes
    (``mesh.halo_ops``, ``mesh.halo_bytes``); an empty write issues
    nothing and counts nothing.  Called only while tracing is on."""
    if t.numel():
        tracing.count("mesh.halo_ops")
        tracing.count("mesh.halo_bytes", t.numel() * t.element_size())


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, queued (no host wait), counted."""
    dst.copy_(src, non_blocking=True)
    if tracing.on():
        _written(dst)


def _fill(t: torch.Tensor, fill) -> None:
    t.fill_(fill)
    if tracing.on():
        _written(t)


def _empty_filled_outside(shape, dtype, device, rows, cols, fill):
    """An uninitialised tensor of `shape` with `fill` everywhere outside
    the window ``[rows[0], rows[1]) x [cols[0], cols[1])`` of its last two
    dims, which the caller then writes: the fill touches only the strips
    around it."""
    out = torch.empty(shape, dtype=dtype, device=device)
    h, w = shape[-2:]
    r0, r1 = min(max(rows[0], 0), h), min(max(rows[1], 0), h)
    c0, c1 = min(max(cols[0], 0), w), min(max(cols[1], 0), w)
    if r1 <= r0 or c1 <= c0:
        _fill(out, fill)
        return out
    _fill(out[..., :r0, :], fill)
    _fill(out[..., r1:, :], fill)
    _fill(out[..., r0:r1, :c0], fill)
    _fill(out[..., r0:r1, c1:], fill)
    return out


def _row_pitch(width: int, dtype: torch.dtype) -> int:
    item = torch.empty((), dtype=dtype).element_size()
    per = max(1, ROW_ALIGN_BYTES // item)
    return -(-width // per) * per


def halo_extend(x: ShardedRaster, halo: HaloSpec, fill=math.nan) -> list:
    """Each tile of `x` with radius-(ry, rx) halos from its neighbours.

    Returns a grid (lists of lists) of tensors, block (i, j) on its
    device, of shape ``(..., t_y + 2*ry, p)``: tile (i, j) at rows
    ``[ry, ry + t_y)`` and columns ``[rx, rx + t_x)`` where ``t_y``,
    ``t_x`` are the full tile sizes, ``p`` the width ``t_x + 2*rx``
    rounded up to ``ROW_ALIGN_BYTES``.  Cells beyond the raster (the
    outer halo, a short tile's padding, the extra columns) are `fill`.
    Two phases: x from the row of tiles, then y from the x-extended
    column of tiles; a halo wider than a tile takes every tile it
    covers.
    """
    with tracing.span("mesh.halo_extend"):
        x = tiles(x)
        ry, rx = halo.ry, halo.rx
        mesh = x.mesh
        ny, nx = mesh.shape["y"], mesh.shape["x"]
        h, w = x.shape[-2:]
        ty, tx = tile_size(h, ny), tile_size(w, nx)
        lead = x.shape[:-2]
        pitch = _row_pitch(tx + 2 * rx, x.dtype)
        # the cells the exchange writes: the raster's cells within the
        # halo (not the row pitch's extra columns)
        ext = [[_empty_filled_outside(
            lead + (ty + 2 * ry, pitch), x.dtype, mesh.device(i, j),
            (ry - i * ty, h - i * ty + ry),
            (rx - j * tx, min(w - j * tx + rx, tx + 2 * rx)), fill)
            for j in range(nx)] for i in range(ny)]
        # phase 1: each tile's own rows, extended in x
        for i in range(ny):
            rows = x.blocks[i][0].shape[-2]
            for j in range(nx):
                dst = ext[i][j][..., ry:ry + rows, :]
                for src, a, b, off in _sources(w, nx, j * tx - rx,
                                               j * tx + tx + rx):
                    _copy(dst[..., off:off + b - a],
                          x.blocks[i][src][..., a:b])
        # phase 2: the halo rows, from the x-extended tiles above and
        # below
        if ry > 0:
            for i in range(ny):
                for j in range(nx):
                    for g0, d0 in ((i * ty - ry, 0), (i * ty + ty, ry + ty)):
                        for src, a, b, off in _sources(h, ny, g0, g0 + ry):
                            d = d0 + off
                            _copy(ext[i][j][..., d:d + b - a, :],
                                  ext[src][j][..., ry + a:ry + b, :])
        return ext


def shifted_blocks(x: ShardedRaster, dy: int, dx: int, fill) -> list:
    """For each block of `x` (split on both axes), the tensor of its own
    shape holding ``x[oy + a + dy, ox + b + dx]`` at (a, b), `fill` beyond
    the raster: a window assembled on the block's device from the tiles
    it overlaps (at most 2 x 2 of them)."""
    if not all(x.split):
        raise ValueError("shifted_blocks takes a raster split on both axes")
    mesh = x.mesh
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    h, w = x.shape[-2:]
    out = []
    for i in range(ny):
        row = []
        oy = x.extent(0, i)[0]
        for j in range(nx):
            blk = x.blocks[i][j]
            hl, wl = blk.shape[-2:]
            ox = x.extent(1, j)[0]
            win = _empty_filled_outside(blk.shape, blk.dtype, blk.device,
                                        (-oy - dy, h - oy - dy),
                                        (-ox - dx, w - ox - dx), fill)
            for si, a, b, offy in _sources(h, ny, oy + dy, oy + dy + hl):
                for sj, c, d, offx in _sources(w, nx, ox + dx,
                                               ox + dx + wl):
                    _copy(win[..., offy:offy + b - a, offx:offx + d - c],
                          x.blocks[si][sj][..., a:b, c:d])
            row.append(win)
        out.append(row)
    return out


def flat_devices(mesh: RasterMesh) -> list:
    """The mesh's devices in row-major order: strip p of ``to_strips`` lies
    on device p (the JAX package's ``mesh.devices.reshape(-1)``)."""
    return [d for row in mesh.devices for d in row]


def to_strips(x: ShardedRaster, axis: int, halos, fill) -> list:
    """`x` cut into P = mesh size strips across spatial `axis` (0: strips
    of rows, 1: strips of columns) over the flattened mesh.

    Strip p lies on ``flat_devices(mesh)[p]`` and owns the lanes (rows or
    columns) ``[p * S, (p + 1) * S)``, S = ceil(n / P), extended by
    ``halos[p] = (lo, hi)`` lanes below and above: a tensor of ``(S + lo
    + hi, w)`` for axis 0, ``(h, S + lo + hi)`` for axis 1 (the JAX
    package's ``P("d", None)`` layout with its halos).  Lanes beyond the
    raster hold `fill`, so a raster that does not divide pads its last
    strip.  One copy a piece of a block, device to device.
    """
    x = tiles(x)
    mesh = x.mesh
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    n = (h, w)[axis]
    s = tile_size(n, mesh.size)
    out = []
    for p, dev in enumerate(flat_devices(mesh)):
        lo, hi = halos[p]
        g0, g1 = p * s - lo, (p + 1) * s + hi
        if axis == 0:
            buf = _empty_filled_outside(lead + (g1 - g0, w), x.dtype, dev,
                                        (-g0, n - g0), (0, w), fill)
            for i, a, b, off in _sources(h, ny, g0, g1):
                for j in range(nx):
                    x0, x1 = x.extent(1, j)
                    _copy(buf[..., off:off + b - a, x0:x1],
                          x.blocks[i][j][..., a:b, :])
        else:
            buf = _empty_filled_outside(lead + (h, g1 - g0), x.dtype, dev,
                                        (0, h), (-g0, n - g0), fill)
            for j, a, b, off in _sources(w, nx, g0, g1):
                for i in range(ny):
                    y0, y1 = x.extent(0, i)
                    _copy(buf[..., y0:y1, off:off + b - a],
                          x.blocks[i][j][..., :, a:b])
        out.append(buf)
    return out


def from_strips(strips, like: ShardedRaster, axis: int, offsets
                ) -> ShardedRaster:
    """The inverse of ``to_strips``: a raster of `like`'s tiles, each block
    assembled on its device from the strips' owned lanes (strip p's first
    owned lane at index ``offsets[p]`` of its `axis`), one copy a piece."""
    like = tiles(like)
    mesh = like.mesh
    h, w = like.shape[-2:]
    n = (h, w)[axis]
    lead = tuple(strips[0].shape[:-2])
    blocks = []
    for i in range(mesh.shape["y"]):
        row = []
        for j in range(mesh.shape["x"]):
            (y0, y1), (x0, x1) = like.extent(0, i), like.extent(1, j)
            blk = torch.empty(lead + (y1 - y0, x1 - x0),
                              dtype=strips[0].dtype,
                              device=mesh.device(i, j))
            a0, a1 = (y0, y1) if axis == 0 else (x0, x1)
            for p, a, b, off in _sources(n, mesh.size, a0, a1):
                src = strips[p]
                a, b = a + offsets[p], b + offsets[p]
                if axis == 0:
                    _copy(blk[..., off:off + b - a, :], src[..., a:b, x0:x1])
                else:
                    _copy(blk[..., :, off:off + b - a], src[..., y0:y1, a:b])
            row.append(blk)
        blocks.append(row)
    return ShardedRaster(blocks, lead + (h, w), mesh, (True, True))


def inplace_fits(x: ShardedRaster, halo: HaloSpec) -> bool:
    """Whether a stencil of radius (ry, rx) on `x` may run in place: every
    tile its stencils cut ``x`` into (``tiles``) has at least 4 * ry rows
    and 4 * rx columns, and a cell.  Each band then takes its halo strips
    from the next tiles alone and its edge strips from its own tile, and
    no cell it keeps reads past its own part."""
    ny, nx = x.mesh.shape["y"], x.mesh.shape["x"]
    h, w = x.spatial
    return (all(b - a >= max(4 * halo.ry, 1)
                for a, b in (tile_extent(h, ny, i) for i in range(ny)))
            and all(b - a >= max(4 * halo.rx, 1)
                    for a, b in (tile_extent(w, nx, j) for j in range(nx))))


def _put(dst: torch.Tensor, src, fill) -> None:
    """Copy `src` into `dst`, or `fill` it where there is no source (beyond
    the raster)."""
    if src is None:
        _fill(dst, fill)
    else:
        _copy(dst, src)


def _pair(t: torch.Tensor, dim: int, a: int, b: int, n: int) -> torch.Tensor:
    """The view of `t` holding its slices ``[a, a + n)`` and ``[b, b + n)``
    along `dim` (-2 or -1) as a new dim of 2 before it: a tile's two edge
    strips, a band's two parts or a ring's two edges, in one copy."""
    d = t.dim() + dim
    s = t.stride()
    return t.as_strided(t.shape[:d] + (2, n) + t.shape[d + 1:],
                        s[:d] + ((b - a) * s[d],) + s[d:],
                        t.storage_offset() + a * s[d])


def _bands(x: ShardedRaster, halo: HaloSpec, fill) -> list:
    """Every block's two bands on its device, a grid of (rows, cols), None
    where the radius across them is 0; `fill` beyond the raster.  The
    tiles must be ``inplace_fits``: every strip then comes from a tile
    next to the block's own.

    rows: ``(..., 8 ry, p)``, two parts of 4 ry rows stacked, each ``tx +
    2 rx`` columns from the tile's first column less rx: the raster's rows
    from ry above the tile to 3 ry inside it, and from 3 ry inside its
    bottom to ry below it.  Each part's middle 2 ry rows are kept: the
    tile's outer 2 ry rows, corners included.  The tile's own pass keeps
    only the rows past them, which holds a whole raster's bits on the CPU
    too, where torch ends a flat pass (the tile's last inner row) on a
    scalar path.  cols: ``(..., ty, q)``, two parts of 3 rx columns side by
    side over the tile's rows: the columns from rx left of the tile to 2
    rx inside it, and from 2 rx inside its right edge to rx past it; each
    part's middle rx columns are kept.  Past those columns each band holds
    ``BAND_SLACK`` columns of fill, its width then rounded up to
    ``ROW_ALIGN_BYTES`` (TMA's rule).

    Every cell is written once, in ``halo_extend``'s two phases, so that
    no strip comes from a diagonal neighbour: first each band's rows of
    its own row of tiles, one op a tile in x (both parts at once: the
    tile's, its neighbours' rx columns, fill beyond the raster), and the
    column band (the tile's columns, one op a side); then the halo rows
    of each row band, one copy each from the row bands of the blocks
    above and below, which hold those rows already extended in x."""
    ry, rx = halo.ry, halo.rx
    grid = [[_bands_x(x, i, j, halo, fill) for j in range(len(row))]
            for i, row in enumerate(x.blocks)]
    if ry:
        for i, row in enumerate(grid):
            for j, (rows, _) in enumerate(row):
                wr = x.blocks[i][j].shape[-1] + 2 * rx
                # rows [6 ry, 7 ry) of the band above are the last ry of
                # its tile; rows [ry, 2 ry) of the band below its first
                for di, r0, a in ((-1, 0, 6 * ry), (1, 7 * ry, ry)):
                    dst = rows[..., r0:r0 + ry, :wr]
                    if 0 <= i + di < len(grid):
                        _copy(dst, grid[i + di][j][0][..., a:a + ry, :wr])
                    else:
                        _fill(dst, fill)
    return grid


def _bands_x(x: ShardedRaster, i: int, j: int, halo: HaloSpec,
             fill) -> tuple:
    """Block (i, j)'s bands with every cell but the row band's halo rows
    written (``_bands``' first phase)."""
    ry, rx = halo.ry, halo.rx
    own = x.blocks[i][j]
    lead, dev = tuple(own.shape[:-2]), x.mesh.device(i, j)
    hl, wl = own.shape[-2:]
    nx = len(x.blocks[i])
    # the rx columns next to the tile, None beyond the raster
    left = x.blocks[i][j - 1][..., -rx:] if rx and j > 0 else None
    right = x.blocks[i][j + 1][..., :rx] if rx and j + 1 < nx else None
    rows = cols = None
    if ry:
        wr = wl + 2 * rx
        rows = torch.empty(lead + (8 * ry,
                                   _row_pitch(wr + BAND_SLACK, x.dtype)),
                           dtype=x.dtype, device=dev)
        # the tile's first and last 3 ry rows, both parts in one op
        mid = _pair(rows, -2, ry, 4 * ry, 3 * ry)
        _copy(mid[..., rx:rx + wl], _pair(own, -2, 0, hl - 3 * ry, 3 * ry))
        if rx:
            for c0, src in ((0, left), (rx + wl, right)):
                _put(mid[..., c0:c0 + rx], None if src is None else
                     _pair(src, -2, 0, hl - 3 * ry, 3 * ry), fill)
        _fill(rows[..., wr:], fill)
    if rx:
        cols = torch.empty(lead + (hl,
                                   _row_pitch(6 * rx + BAND_SLACK, x.dtype)),
                           dtype=x.dtype, device=dev)
        _copy(_pair(cols, -1, rx, 3 * rx, 2 * rx),
              _pair(own, -1, 0, wl - 2 * rx, 2 * rx))
        _put(cols[..., :rx], left, fill)
        _put(cols[..., 5 * rx:6 * rx], right, fill)
        _fill(cols[..., 6 * rx:], fill)
    return rows, cols


def _mend(out: torch.Tensor, rows_out, cols_out, halo: HaloSpec) -> None:
    """Write the edge ring of a tile's output `out` from its bands'
    outputs: the top and bottom 2 ry rows from the kept rows of the row
    band's parts, the left and right rx columns between them from the kept
    columns of the column band's parts; one copy each."""
    ry, rx = halo.ry, halo.rx
    hl, wl = out.shape[-2:]
    if rows_out is not None:
        _pair(out, -2, 0, hl - 2 * ry, 2 * ry).copy_(
            _pair(rows_out, -2, ry, 5 * ry, 2 * ry)[..., rx:rx + wl])
    if cols_out is not None:
        _pair(out[..., 2 * ry:hl - 2 * ry, :], -1, 0, wl - rx, rx).copy_(
            _pair(cols_out[..., 2 * ry:hl - 2 * ry, :], -1, rx, 4 * rx, rx))


def stencil_shard_map(kernel: Callable, mesh: RasterMesh, halo: HaloSpec,
                      out_leading_dims: Optional[int] = None,
                      fill=math.nan, origin: bool = False,
                      window_local: bool = True) -> Callable:
    """Distribute a radius-(ry, rx) local kernel over the mesh.

    Returns ``run(data, *args)`` for a ``ShardedRaster`` `data` on `mesh`.
    The kernel computes a full-size output of its input whose ring of
    width (ry, rx) is edge garbage; it may return extra leading dims (a
    stats axis), their number checked when `out_leading_dims` is given,
    or a tuple of such outputs (several products of one pass), and the
    result is then a tuple.  Each result is split over the same mesh on
    both axes.  `fill` is the value beyond the raster.

    Two routes, one result:

    - in place, where ``inplace_fits`` (each tile at least four halos
      deep) and the kernel is `window_local` (a cell's output reads its
      radius-(ry, rx) window and nothing else) and takes no `origin`:
      ``kernel(tile, *args)`` on every block first, so that each device
      has its interior queued before any strip is gathered; then every
      block's bands (``_bands``, span ``mesh.halo_extend``); then the
      kernel on each band and the ring of each output rebuilt from the
      bands' (``_mend``).  The outputs are the tile-shaped tensors the
      kernel returned.
    - extended, otherwise: each tile is extended by ``halo_extend`` and
      ``kernel(extended, *args)`` (``kernel(extended, (y0, x0), *args)``
      with `origin`, (y0, x0) the raster's cell of the extended block's
      (0, 0), negative in the outer halo); the tile's own cells are
      cropped from its output (a view: no copy).

    The counters ``mesh.inplace_blocks`` and ``mesh.extended_blocks`` add
    the blocks of each call to the route it took.
    """
    ry, rx = halo.ry, halo.rx

    def outputs(out, many: bool) -> tuple:
        """The kernel's output(s) as a tuple, their dims checked."""
        outs = tuple(out) if many else (out,)
        for o in outs:
            if out_leading_dims is not None \
                    and o.ndim != 2 + out_leading_dims:
                raise ValueError(f"stencil_shard_map: the kernel gave "
                                 f"{o.ndim} dims, expected "
                                 f"{2 + out_leading_dims}")
        return outs

    def in_place(t: ShardedRaster, args) -> tuple:
        raw = [[kernel(b, *args) for b in row] for row in t.blocks]
        many = isinstance(raw[0][0], (tuple, list))
        grid = [[outputs(o, many) for o in row] for row in raw]
        for brow, row in zip(t.blocks, grid):
            for b, outs in zip(brow, row):
                if any(o.shape[-2:] != b.shape[-2:] for o in outs):
                    raise ValueError(
                        f"stencil_shard_map: the kernel gave "
                        f"{[tuple(o.shape) for o in outs]} for a tile of "
                        f"{tuple(b.shape[-2:])}")
        with tracing.span("mesh.halo_extend"):
            bands = _bands(t, halo, fill)
        for i, row in enumerate(grid):
            for j, outs in enumerate(row):
                rows_out, cols_out = (
                    None if b is None else outputs(kernel(b, *args), many)
                    for b in bands[i][j])
                bands[i][j] = None
                for q, o in enumerate(outs):
                    _mend(o, None if rows_out is None else rows_out[q],
                          None if cols_out is None else cols_out[q], halo)
        return grid, many

    def extended(t: ShardedRaster, args) -> tuple:
        ext = halo_extend(t, halo, fill)
        grid, many = [], None
        for i, row in enumerate(ext):
            orow = []
            for j in range(len(row)):
                hl, wl = t.blocks[i][j].shape[-2:]
                # each extended block is released once its kernel ran
                e, row[j] = row[j], None
                out = (kernel(e, (t.extent(0, i)[0] - ry,
                                  t.extent(1, j)[0] - rx), *args)
                       if origin else kernel(e, *args))
                del e
                if many is None:
                    many = isinstance(out, (tuple, list))
                orow.append(tuple(o[..., ry:ry + hl, rx:rx + wl]
                                  for o in outputs(out, many)))
            grid.append(orow)
        return grid, many

    def run(data: ShardedRaster, *args):
        if data.mesh is not mesh:
            raise ValueError("stencil_shard_map: the raster lies on another "
                             "mesh")
        t = tiles(data)
        if window_local and not origin and inplace_fits(t, halo):
            tracing.count("mesh.inplace_blocks", mesh.size)
            grid, many = in_place(t, args)
        else:
            tracing.count("mesh.extended_blocks", mesh.size)
            grid, many = extended(t, args)
        results = tuple(
            ShardedRaster([[outs[q] for outs in row] for row in grid],
                          tuple(grid[0][0][q].shape[:-2]) + data.shape[-2:],
                          mesh, (True, True))
            for q in range(len(grid[0][0])))
        return results if many else results[0]

    return run

"""Main-path times and result digests, for comparing two trees of the
package on one card.

    python -m xrspatial_torch.tools.time_paths [LABEL]
    python OTHER_TREE/xrspatial_torch/tools/time_paths.py [LABEL]

The package is imported from the working directory, so the second form
times the tree it is run from with this file, which only calls what every
tree of the port since the mesh has (``cuda_xdraw.xdraw_scan_cuda``,
``local.cell_stats``, ``slope(method="geodesic")``).  Run it from the
root of each tree in turns (parent, change, change, parent) within one
chip call.  With CUDA events it times: X1 (the XDraw scan, its default
route) on ``gaussian_bump``'s slope field at 16384^2 from the JAX bench's
viewpoint; ``cell_stats`` sum and std over three 16384^2 float32
variables; geodesic ``slope`` on a 3600^2 tile of 1/3600-degree
coordinates.  Beside each time it prints a digest of the result's bits
(the sum of its 32-bit words and its NaN count), so that two trees'
results can be seen to be equal.  Prints the card's line and one line
``LABEL {...}``.  Without a card it exits 1.
"""

from __future__ import annotations

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 16384
GEO_N = 3600
VIEW = (100, 100, 100.0)      # the JAX bench's x, y and observer_elev


def digest(t: torch.Tensor) -> list:
    """[the sum of the float32 result's 32-bit words, its NaN count]."""
    t = t.to(torch.float32).contiguous()
    return [int(t.view(torch.int32).to(torch.int64).sum()),
            int(torch.isnan(t).sum())]


def measure() -> dict:
    """{leg: ms} and {leg: digest} of the three paths."""
    import xrspatial_torch as xt
    from xrspatial_torch import local
    from xrspatial_torch.kernels import _cuda, cuda_xdraw
    from xrspatial_torch.kernels import viewshed as kv
    from xrspatial_torch.tools._probe import device_ms, gaussian_bump
    dev = torch.device("cuda", 0)
    _cuda.library()
    ms, bits = {}, {}

    dem = gaussian_bump(N, N, dev)
    vp = (N - 1 - VIEW[1], VIEW[0])
    slope = kv._xdraw_fields(dem, *vp, VIEW[2], 0.0, 1.0, -1.0)[3]
    ms["x1"] = device_ms(lambda: cuda_xdraw.xdraw_scan_cuda(slope, *vp), 20)
    bits["x1"] = digest(cuda_xdraw.xdraw_scan_cuda(slope, *vp))
    del slope

    g = torch.Generator(device=dev).manual_seed(28)
    ds = xt.Dataset({"a": xt.DataArray(dem, dims=("y", "x")),
                     "b": xt.DataArray(torch.rand((N, N), generator=g,
                                                  device=dev) * 4000.0,
                                       dims=("y", "x")),
                     "c": xt.DataArray(dem.t().contiguous(),
                                       dims=("y", "x"))})
    for func in ("sum", "std"):
        def call(func=func):
            return local.cell_stats(ds, ["a", "b", "c"], func=func).data
        ms[f"cell_stats_{func}"] = device_ms(call, 10)
        bits[f"cell_stats_{func}"] = digest(call())
    del ds, dem
    torch.cuda.empty_cache()

    lat = 46.0 - np.arange(GEO_N) / 3600.0
    lon = 7.0 + np.arange(GEO_N) / 3600.0
    geo = xt.DataArray(gaussian_bump(GEO_N, GEO_N, dev), dims=("y", "x"),
                       coords={"y": lat, "x": lon})

    def geodesic():
        return xt.slope(geo, method="geodesic").data
    ms["geodesic_slope"] = device_ms(geodesic, 10)
    bits["geodesic_slope"] = digest(geodesic())
    return ms, bits


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_paths needs an NVIDIA card: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1
    from xrspatial_torch.tools._probe import header
    label = argv[0] if argv else "tree"
    header(torch.device("cuda", 0))
    ms, bits = measure()
    print(label, {k: round(v, 4) for k, v in ms.items()}, "digests", bits)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

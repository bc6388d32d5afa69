"""Command-line entry point: ``python -m xrspatial_torch <command>``.

Counterpart of ``xrspatial_tpu/__main__.py``.  Commands: ``examples``
(list the bundled datasets), ``fetch-data [path]`` (copy the bundled
sample data into a directory; the data ships with the package, so
"fetching" is a local copy) and ``info`` (torch, CUDA and the cards).
"""

from __future__ import annotations

import sys


def main(args=None):
    args = list(sys.argv[1:] if args is None else args)
    cmd = args[0] if args else "info"
    if cmd == "examples":
        from .datasets import available_datasets
        print("Available bundled datasets:")
        for name in available_datasets or ["(none bundled)"]:
            print(f"  - {name}")
        return 0
    if cmd == "fetch-data":
        import os
        import shutil

        from .datasets import _module_path, available_datasets
        target = args[1] if len(args) > 1 else "./data"
        os.makedirs(target, exist_ok=True)
        for name in available_datasets:
            dst = os.path.join(target, name)
            shutil.copytree(os.path.join(_module_path, name), dst,
                            dirs_exist_ok=True)
            print(f"copied {name} -> {dst}")
        if not available_datasets:
            print("no bundled datasets to fetch")
        return 0
    if cmd == "info":
        import torch

        from . import __version__, default_device
        print(f"xrspatial_torch {__version__}")
        print(f"torch {torch.__version__} cuda={torch.version.cuda} "
              f"available={torch.cuda.is_available()}")
        cards = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        print(f"devices: {cards or ['(no CUDA device)']}; numpy rasters "
              f"go to {default_device()}")
        return 0
    print(f"Unknown command {cmd!r}. Available: examples, fetch-data, "
          "info")
    return 1


if __name__ == "__main__":
    sys.exit(main())

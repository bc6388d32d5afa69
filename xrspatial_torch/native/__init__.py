"""Native (C++) host code, built on demand with the system g++.

Counterpart of ``xrspatial_tpu/native/__init__.py``.  A*'s priority-queue
loop is sequential and runs on the host: ``astar.cpp`` (a copy of the JAX
package's) compiles once into ``native/_build/libastar.so`` and loads
through ctypes.  This is host code, not a device fallback: where g++ is
missing or fails, or ``XRSPATIAL_NO_NATIVE=1`` is set, ``get_astar``
returns None and the caller runs the Python implementation, which gives
the same path and costs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_CACHE: dict = {}


def _compile(name: str) -> str:
    """Compile ``<name>.cpp`` into ``_build/lib<name>.so``; return path."""
    src = os.path.join(_HERE, f"{name}.cpp")
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)  # atomic: parallel test workers may race here
    return out


def _load(name: str):
    if os.environ.get("XRSPATIAL_NO_NATIVE") == "1":
        return None
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        try:
            lib = ctypes.CDLL(_compile(name))
        except Exception as e:  # no g++, a read-only tree, a bad toolchain
            print(f"xrspatial_torch: native '{name}' unavailable "
                  f"({type(e).__name__}); using the Python implementation",
                  file=sys.stderr)
            lib = None
        _CACHE[name] = lib
        return lib


def get_astar():
    """ctypes handle to ``xrspatial_astar``, or None."""
    lib = _load("astar")
    if lib is None:
        return None
    fn = lib.xrspatial_astar
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # blocked
        ctypes.c_int64, ctypes.c_int64,   # h, w
        ctypes.c_int64, ctypes.c_int64,   # start y, x
        ctypes.c_int64, ctypes.c_int64,   # goal y, x
        ctypes.c_int32,                   # connectivity
        ctypes.POINTER(ctypes.c_double),  # d_from_start (inf-filled)
        ctypes.POINTER(ctypes.c_int64),   # path_out
        ctypes.POINTER(ctypes.c_int64),   # path_len
    ]
    return fn

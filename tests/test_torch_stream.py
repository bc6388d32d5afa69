"""The stream probes' plain versions on the CPU.

``kernels/stream.py`` holds the twins of the CUDA stream probes (the JAX
package's ``tools/measure_stream.py`` probes copy and add): ``x.clone()``
and ``x + y``, which must equal numpy's copy and float32 sum, and the JAX
package's ``x + 0.0`` and ``x + y``, bit for bit.  On a CPU tensor the
dispatchers ``copy`` and ``add`` take the twins.  ``copy_plan`` and
``add_plan``, the kernels' split into a scalar head, a 16-byte-aligned
body and a scalar tail (their launcher checks the same rule), are pinned
at every alignment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xrspatial_torch.kernels import stream

SHAPES = [(1,), (7,), (33, 65), (256, 1027)]


def pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1e3).astype(np.float32)
    y = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    x.flat[0] = np.nan
    y.flat[-1] = -np.inf
    return x, y


@pytest.mark.parametrize("shape", SHAPES)
def test_copy_twin_and_dispatch_equal_the_input(shape):
    x, _ = pair(shape)
    t = torch.from_numpy(x)
    for fn in (stream.stream_copy, stream.copy):
        out = fn(t)
        assert out.data_ptr() != t.data_ptr()
        assert np.array_equal(out.numpy().view(np.int32), x.view(np.int32))
        jax_copy = np.asarray(jnp.asarray(x) + jnp.float32(0.0))
        assert np.array_equal(out.numpy(), jax_copy, equal_nan=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_add_twin_and_dispatch_equal_numpy_and_jax(shape):
    x, y = pair(shape, seed=1)
    ref = x + y
    jax_ref = np.asarray(jnp.asarray(x) + jnp.asarray(y))
    for fn in (stream.stream_add, stream.add):
        out = fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert out.dtype == np.float32
        assert np.array_equal(out.view(np.int32), ref.view(np.int32))
        assert np.array_equal(out.view(np.int32), jax_ref.view(np.int32))


def test_measure_stream_refuses_without_a_card(monkeypatch):
    from xrspatial_torch.tools import measure_stream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert measure_stream.main([]) == 1
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        measure_stream.measure(64)


@pytest.mark.parametrize("ax", range(16))
def test_copy_plan_splits_at_16_byte_boundaries(ax):
    """Head, body and tail over pointer alignments 0-15 (x at `ax`, y at
    every alignment) and lengths 0-100: they sum to n; with x and y alike
    mod 16 (and 4-byte aligned) the body starts 16-byte aligned in both,
    is whole 16-byte groups and leaves fewer than 4 values on each side;
    otherwise every value is scalar."""
    for ay in range(16):
        x_ptr, y_ptr = 4096 + ax, 8192 + 64 + ay
        for n in range(101):
            head, body, tail = stream.copy_plan(n, x_ptr, y_ptr)
            assert min(head, body, tail) >= 0 and head + body + tail == n
            if ax != ay or ax % 4:
                assert (head, body, tail) == (0, 0, n)
                continue
            assert body % 4 == 0 and tail < 4 and head < 4
            if body:
                assert (x_ptr + 4 * head) % 16 == 0
                assert (y_ptr + 4 * head) % 16 == 0
            if n >= head + 4:
                assert body > 0


def test_copy_plan_of_an_aligned_raster_is_all_body():
    assert stream.copy_plan(16384 * 16384, 1 << 20, 1 << 21) == (
        0, 16384 * 16384, 0)
    assert stream.copy_plan(7, 256 + 8, 512 + 8) == (2, 4, 1)
    assert stream.copy_plan(3, 256 + 4, 512 + 4) == (3, 0, 0)


@pytest.mark.parametrize("ax", range(16))
def test_add_plan_splits_at_16_byte_boundaries(ax):
    """Head, body and tail over alignments 0-15 of x (at `ax`), y and z
    (at every alignment each) and lengths 0-40: they sum to n; with all
    three alike mod 16 (and 4-byte aligned) the body starts 16-byte
    aligned in each, is whole 16-byte groups and leaves fewer than 4
    values on each side; otherwise every value is scalar.  With y == z
    it is the copy's plan."""
    for ay in range(16):
        for az in range(16):
            ptrs = 4096 + ax, 8192 + 64 + ay, 16384 + 32 + az
            for n in range(41):
                head, body, tail = stream.add_plan(n, *ptrs)
                assert min(head, body, tail) >= 0
                assert head + body + tail == n
                if az == ay:
                    assert (head, body, tail) == stream.copy_plan(
                        n, *ptrs[:2])
                if not ax == ay == az or ax % 4:
                    assert (head, body, tail) == (0, 0, n)
                    continue
                assert body % 4 == 0 and tail < 4 and head < 4
                if body:
                    assert all((p + 4 * head) % 16 == 0 for p in ptrs)
                if n >= head + 4:
                    assert body > 0


def test_add_plan_of_an_aligned_raster_is_all_body():
    assert stream.add_plan(16384 * 16384, 1 << 20, 1 << 21, 1 << 22) == (
        0, 16384 * 16384, 0)
    assert stream.add_plan(7, 256 + 8, 512 + 8, 768 + 8) == (2, 4, 1)
    assert stream.add_plan(7, 256 + 8, 512 + 8, 768 + 12) == (0, 0, 7)

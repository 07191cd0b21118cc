"""The Hopper SAGA block-step kernel (``ops.saga_block``).

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``
with ``backend="triton"``); each case is checked against a plain f64
numpy step on the same rows: int8 rows against the same quantized
operator, bf16 rows against their exact f32 values. The ``gpu`` test
compiles the kernel for the card and runs only there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rowref import MODES, STORAGES, np_coeff, row_problem

from ciao_tpu.ops.saga_block import (
    block_step_shape, block_step_supported, saga_block_step,
)
from ciao_tpu.solvers.saga import coeff_block_kernel, coeff_block_xla


def _oracle(mode, storage, N, n):
    return row_problem(mode, storage, N, n)


def _np_step(mode, Ad, off, c, z, start, B):
    sl = slice(start, start + B)
    c_new = np_coeff(mode, Ad[sl] @ z, off[sl])
    innov = (c_new - c[sl]) @ Ad[sl]
    c = c.copy()
    c[sl] = c_new
    return c, innov


def _check(F, Ad, off, mode, N, n, B, start, tol=1e-5):
    rng = np.random.default_rng(1)
    c = rng.standard_normal(N).astype(np.float32)
    z = (rng.standard_normal(n) / np.sqrt(n)).astype(np.float32)
    c_k, i_k = coeff_block_kernel(F, jnp.asarray(c), jnp.asarray(z),
                                  jnp.int32(start), B, interpret=True)
    c_r, i_r = _np_step(mode, Ad, off, c.astype(np.float64),
                        z.astype(np.float64), start, B)
    np.testing.assert_allclose(np.asarray(c_k, np.float64), c_r,
                               rtol=tol, atol=tol * np.abs(c_r).max())
    np.testing.assert_allclose(np.asarray(i_k, np.float64), i_r,
                               rtol=tol, atol=tol * np.abs(i_r).max())


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_f64_step(mode, storage):
    """Every coefficient formula and row storage: new coefficients in
    the block, untouched table outside it, and Σ (c_new − c_old)·a_i."""
    N, n, B = 96, 40, 32
    _check(*_oracle(mode, storage, N, n), mode, N, n, B, start=32)


@pytest.mark.parametrize("N, n, B, start", [
    (100, 100, 40, 60),     # tile 16 does not divide the block of 40
    (64, 24, 64, 0),        # the whole table is one block
    (96, 130, 48, 48),      # width just above a power of two
])
def test_kernel_shapes(N, n, B, start):
    _check(*_oracle("lsq", "f32", N, n), "lsq", N, n, B, start)


def test_kernel_dynamic_start():
    """The block start is a traced operand that the kernel loads
    itself: one compiled program serves every start."""
    N, n, B = 96, 16, 16
    F, Ad, off = _oracle("lsq", "f32", N, n)
    rows, offs = F.coeff_rows_data()
    c0 = np.zeros(N, np.float32)
    z = np.linspace(-1, 1, n).astype(np.float32)
    step = jax.jit(functools.partial(
        saga_block_step, B=B, mode=F.coeff_mode, interpret=True))
    for start in (0, 16, 80):
        c_k, i_k = step(rows, offs, None, jnp.asarray(c0), jnp.asarray(z),
                        jnp.int32(start), F.scale, 0.0)
        c_r, i_r = _np_step("lsq", Ad, off, c0.astype(np.float64),
                            z.astype(np.float64), start, B)
        np.testing.assert_allclose(np.asarray(c_k), c_r, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(i_k), i_r, rtol=1e-5,
                                   atol=1e-6)


def test_kernel_agrees_with_xla_step():
    """``coeff_block_kernel`` and ``coeff_block_xla`` are the same step
    (the SAGA facade swaps one for the other)."""
    F, *_ = _oracle("huber", "int8", 64, 32)
    c = jnp.linspace(-1.0, 1.0, 64, dtype=jnp.float32)
    z = jnp.linspace(0.5, -0.5, 32, dtype=jnp.float32)
    c_x, i_x = coeff_block_xla(F, c, z, jnp.int32(16), 32)
    # the kernel updates its table in place (the argument is donated)
    c_k, i_k = coeff_block_kernel(F, c, z, jnp.int32(16), 32,
                                  interpret=True)
    np.testing.assert_allclose(np.asarray(c_k), np.asarray(c_x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(i_k), np.asarray(i_x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B, n, tile, width", [
    (4096, 1024, 16, 1024),   # the SAGA cell: 256 programs of 16 rows
    (4096, 100, 16, 128),     # narrow rows pad to 128 lanes
    (64, 8, 16, 8),           # tiny blocks keep the 16-row floor
    (8192, 32, 32, 32),       # enough programs at 32 rows a tile
])
def test_block_step_shape(B, n, tile, width):
    assert block_step_shape(B, n) == (tile, width)


@pytest.mark.parametrize("N, n, B, dtype, ok", [
    (262_144, 1024, 4096, jnp.float32, True),
    (10 * 1024 * 1024, 100, 8192, jnp.int8, True),
    (262_144, 1025, 4096, jnp.float32, False),     # pads past 1,024
    (262_144, 1024, 2048, jnp.float32, False),     # block below 4,096
    (2 * 1024 * 1024, 1024, 4096, jnp.bfloat16, False),  # 2^31 elements
    (8192, 64, 4096, jnp.float64, False),
])
def test_block_step_supported(N, n, B, dtype, ok):
    assert block_step_supported(N, n, B, dtype) is ok


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this there)")


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    F, Ad, off = _oracle("lsq", "f32", 8192, 256)
    c = jnp.zeros(8192, jnp.float32)
    z = jnp.ones(256, jnp.float32) / 16
    c_k, i_k = coeff_block_kernel(F, c, z, jnp.int32(4096), 2048)
    c_r, i_r = _np_step("lsq", Ad, off, np.zeros(8192),
                        np.ones(256) / 16, 4096, 2048)
    np.testing.assert_allclose(np.asarray(i_k), i_r, rtol=1e-5,
                               atol=1e-5 * np.abs(i_r).max())

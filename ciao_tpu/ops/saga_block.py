"""One coefficient-mode SAGA block step as a Pallas kernel for Hopper.

The step on the contiguous block ``[start, start + B)`` of a rank-1
oracle (``∇f_i(z) = c_i(z)·a_i``) is, per row i of the block::

    r_i   = a_i·z                      (dequantized: r_i ← r_i·rs_i)
    c_new = coeff(r_i, b_i)            (the oracle's formula, coeff.py)
    dc_i  = c_new − c_old_i            (c_old read from the table)
    innov = Σ_i dc_i·a_i               (int8 rows: Σ (dc_i·rs_i)·q_i)

XLA runs this as two matrix-vector products over the same B×n rows, plus
slices of the table. The kernel reads each row tile once: a program of
the grid owns ``tile`` rows, loads them whole into registers, takes the
margins, writes the new coefficients in place and stores the tile's
partial ``dcᵀ A_t``. A second, small pass (XLA) sums the partials; the
prox stays in the solver.

Route: Pallas through Triton (``backend="triton"``). Blocks run in
parallel and in no order, so nothing carries over between programs.
The block start is an operand that each program loads itself. Products
are f32 FMAs on the CUDA cores (no tensor-core rounding), so f32 rows
agree with the plain step at ``Precision.HIGHEST`` to summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ciao_tpu.oracles.coeff import coeff_formula

# A tile's rows are loaded whole, padded to the next power of two. Keep
# a program's tile at or under this many elements (64 KiB of f32 over
# 8 warps is 64 registers a thread) and at least this many rows.
_TILE_ELEMS = 16384
_MIN_TILE = 16
# The shapes the kernel was measured on against the XLA step (PERF.md):
# padded rows up to 1,024 wide (so a 16-row tile stays in the register
# budget above) and blocks of at least 4,096 rows (enough programs for
# the card's 132 SMs).
_MAX_WIDTH = 1024
_MIN_BLOCK = 4096


def block_step_shape(B: int, n: int):
    """(tile, width): the rows a program owns and the padded row width.
    Tiles shrink until the grid has about one program for each of the
    card's 132 SMs, but no further than ``_MIN_TILE`` rows."""
    width = pl.next_power_of_2(n)
    tile = max(_MIN_TILE, _TILE_ELEMS // width)
    while tile > _MIN_TILE and -(-B // tile) < 132:
        tile //= 2
    return tile, width


def block_step_supported(N: int, n: int, B: int, rows_dtype) -> bool:
    """Whether the SAGA facade takes the kernel for block steps of ``B``
    rows over an (N, n) row stack: a shape inside the measured range,
    a storage the kernel reads, and a stack that Triton's 32-bit
    offsets address whole."""
    return (
        pl.next_power_of_2(n) <= _MAX_WIDTH
        and B >= _MIN_BLOCK
        and N * n < 2**31
        and jnp.dtype(rows_dtype) in (jnp.float32, jnp.bfloat16, jnp.int8)
    )


def _kernel(start_ref, a_ref, b_ref, *refs, B, tile, width, mode, quant):
    refs = list(refs)
    rs_ref = refs.pop(0) if quant else None
    # the table input (refs[0]) is aliased to the output c_ref: it is
    # read and written through c_ref
    _, z_ref, sc_ref, c_ref, part_ref = refs
    i = pl.program_id(0)
    n = a_ref.shape[1]
    local = i * tile + jnp.arange(tile)
    rmask = local < B
    rows = start_ref[0] + local
    cols = jnp.arange(width)
    cmask = cols < n
    a = plgpu.load(
        a_ref.at[rows[:, None], cols[None, :]],
        mask=rmask[:, None] & cmask[None, :], other=0,
    ).astype(jnp.float32)
    z = plgpu.load(z_ref.at[cols], mask=cmask, other=0.0)
    r = jnp.sum(a * z[None, :], axis=1)
    if rs_ref is not None:
        rs = plgpu.load(rs_ref.at[rows], mask=rmask, other=0.0)
        r = r * rs
    b = plgpu.load(b_ref.at[rows], mask=rmask, other=0.0)
    c_old = plgpu.load(c_ref.at[rows], mask=rmask, other=0.0)
    c_new = coeff_formula(mode, r, b, sc_ref[0], sc_ref[1])
    plgpu.store(c_ref.at[rows], c_new, mask=rmask)
    dc = jnp.where(rmask, c_new - c_old, 0.0)
    if rs_ref is not None:
        dc = dc * rs
    plgpu.store(part_ref.at[i, cols], jnp.sum(dc[:, None] * a, axis=0),
                mask=cmask)


@functools.partial(
    jax.jit, static_argnames=("B", "mode", "interpret"), donate_argnums=(3,)
)
def saga_block_step(rows, offs, rs, c, z, start, scale, aux, *, B: int,
                    mode: int, interpret: bool = False):
    """One block step: returns ``(c_updated, innov)``.

    ``rows`` (N, n) f32/bf16/int8, ``offs`` (N,) offsets or labels,
    ``rs`` (N,) int8 dequant scales or None, ``c`` (N,) f32 coefficient
    table (donated, updated in place), ``z`` (n,) f32, ``start`` the
    block's first row (traced int), ``scale``/``aux`` the oracle's
    scalars, ``mode`` its static ``coeff_mode``. ``innov`` is
    Σ (c_new − c_old)·a_i over the block."""
    N, n = rows.shape
    tile, width = block_step_shape(B, n)
    T = pl.cdiv(B, tile)
    rs_ops = () if rs is None else (rs.astype(jnp.float32),)
    kernel = functools.partial(_kernel, B=B, tile=tile, width=width,
                               mode=mode, quant=rs is not None)
    sc = jnp.stack([jnp.asarray(scale, jnp.float32),
                    jnp.asarray(aux, jnp.float32)])
    c_idx = 3 + len(rs_ops)
    c_new, part = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((N,), jnp.float32),
            jax.ShapeDtypeStruct((T, n), jnp.float32),
        ],
        grid=(T,),
        input_output_aliases={c_idx: 0},
        compiler_params=plgpu.CompilerParams(num_warps=8, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="saga_block_step",
    )(
        jnp.reshape(start, (1,)).astype(jnp.int32), rows,
        offs.astype(jnp.float32), *rs_ops, c, z.astype(jnp.float32), sc,
    )
    return c_new, jnp.sum(part, axis=0)


"""Numbering and formulas of the rank-1 coefficient oracles.

Every row oracle whose gradient is ``∇f_i(x) = c_i(x)·a_i`` with a
SCALAR coefficient of the margin ``r_i = a_i·x`` carries a class-level
``coeff_mode`` from this table. Code that works on raw margins (the
Hopper SAGA block-step kernel, the numpy references in the tests) picks
the formula by that number, so oracle and kernel compute one function.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MODE_LSQ = 0       # c = scale·(r − b)                  (least squares)
MODE_LOGISTIC = 1  # c = −y·σ(−y·r)                     (logistic; b = y)
MODE_HUBER = 2     # c = scale·clip(r − b, ±δ)          (Huber; aux = δ)
MODE_SQHINGE = 3   # c = −scale·y·max(0, 1 − y·r)       (squared hinge)
MODE_POISSON = 4   # c = scale·(exp(min(r, M)) − y)     (Poisson, log link)

# Poisson link safeguard: beyond margin M the exponential is extended
# LINEARLY (value) / frozen (coefficient), so the pair stays a
# consistent C¹ loss and exp never overflows f32.
POISSON_CLAMP = 30.0


def coeff_formula(mode: int, r, b, scale, aux=0.0):
    """c(r) of the oracle numbered ``mode`` (a static int) at the
    dequantized margins ``r``; ``b`` holds the offsets or labels."""
    if mode == MODE_LSQ:
        return scale * (r - b)
    if mode == MODE_LOGISTIC:
        return -b * jax.nn.sigmoid(-b * r)
    if mode == MODE_HUBER:
        return scale * jnp.clip(r - b, -aux, aux)
    if mode == MODE_SQHINGE:
        return -scale * b * jnp.maximum(1.0 - b * r, 0.0)
    if mode == MODE_POISSON:
        return scale * (jnp.exp(jnp.minimum(r, POISSON_CLAMP)) - b)
    raise ValueError(f"unknown coefficient mode {mode}")

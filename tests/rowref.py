"""Shared by the kernel and stepwise-reference tests: one small problem
per rank-1 row oracle and storage, with its rows and offsets in f64 and
the coefficient formulas written out in numpy, independent of the
library's code."""

import jax.numpy as jnp
import numpy as np

from ciao_tpu.oracles import (
    HuberRows, LeastSquaresRows, LogisticRows, PoissonRows,
    SquaredHingeRows,
)

MODES = ["lsq", "logistic", "huber", "sqhinge", "poisson"]
STORAGES = ["f32", "bf16", "int8"]
SCALE, DELTA = 1.5, 0.4


def np_coeff(mode, r, b):
    """c(r) of each oracle at margins ``r`` (offsets or labels ``b``)."""
    if mode == "lsq":
        return SCALE * (r - b)
    if mode == "logistic":                 # −b·σ(−b·r), overflow-free
        return -0.5 * b * (1.0 - np.tanh(0.5 * b * r))
    if mode == "huber":
        return SCALE * np.clip(r - b, -DELTA, DELTA)
    if mode == "sqhinge":
        return -SCALE * b * np.maximum(1.0 - b * r, 0.0)
    return SCALE * (np.exp(np.minimum(r, 30.0)) - b)


def row_problem(mode, storage, N, n, seed=0):
    """(oracle, f64 rows as stored, f64 offsets/labels)."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((N, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sign(rng.standard_normal(N)).astype(np.float32)
    cnt = rng.poisson(2.0, N).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    A_, s_ = jnp.asarray(A), jnp.asarray(SCALE, jnp.float32)
    F, off = {
        "lsq": (LeastSquaresRows(A=A_, b=jnp.asarray(b), scale=s_), b),
        "logistic": (LogisticRows(X=A_, y=jnp.asarray(y)), y),
        "huber": (HuberRows(A=A_, b=jnp.asarray(b),
                            delta=jnp.asarray(DELTA, jnp.float32),
                            scale=s_), b),
        "sqhinge": (SquaredHingeRows(A=A_, y=jnp.asarray(y), scale=s_), y),
        "poisson": (PoissonRows(A=A_, y=jnp.asarray(cnt), scale=s_), cnt),
    }[mode]
    if storage != "f32":
        F = F.with_storage(storage)
    rows, _ = F.coeff_rows_data()
    Ad = np.asarray(rows.astype(jnp.float32), np.float64)
    if F.coeff_rows_scale() is not None:
        Ad = Ad * np.asarray(F.coeff_rows_scale(), np.float64)[:, None]
    return F, Ad, off.astype(np.float64)

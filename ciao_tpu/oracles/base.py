"""Smooth-term oracle protocol.

The reference interacts with its smooth terms exclusively through
``gradient(f_i, x) -> (grad, value)`` / ``gradient!(out, f_i, x) -> value``
on *per-index closure objects* (ProximalOperators.jl; see e.g.
reference ``src/algorithms/Finito/Finito_basic.jl:78,112``).

The accelerator-native inversion: one oracle object owns the data of
ALL ``N`` terms as stacked device arrays, and exposes *batched*
gradient entry points so that the hot paths are gathers + matmuls
rather than N scalar closure calls:

  * ``grad_batch(x, idx)``      — per-sample grads of the gathered index
                                  batch, all evaluated at the same point
                                  (Finito/SAGA table updates).
  * ``grad_sum_batch(x, idx)``  — only the SUM of those grads (LFinito /
                                  SVRG anchor block work; avoids
                                  materializing the (B, n) block).
  * ``grad_sum_diff(x1,x2,idx)``— sum_i (grad_i(x1) - grad_i(x2)); the
                                  LFinito inner update, fusable into a
                                  single matmul pair for linear-gradient
                                  oracles.
  * ``grad_sum_all(x)``         — full-pass gradient sum (SVRG anchor,
                                  solver init), a single matmul for
                                  row-structured oracles.
  * ``grad_pointwise(xs, idx)`` — per-sample grads with PER-SAMPLE
                                  evaluation points (ProShI blocks).

All methods are pure and jit/vmap/shard_map friendly. Oracles are
registered as pytrees: array fields are leaves (so one compiled solver
step serves every problem instance of the same shape), static metadata
goes in the treedef.
"""

from __future__ import annotations

import abc
import dataclasses
import functools
import inspect
from typing import Any, Tuple

import jax
import jax.numpy as jnp


def register_oracle(cls):
    """Register a dataclass oracle as a JAX pytree.

    Fields with ``metadata={"static": True}`` become treedef metadata.
    """
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls


def highest_precision(cls):
    """Trace every method of a dense-row oracle under
    ``Precision.HIGHEST``. On a GPU a float32 product may otherwise run
    in TF32 (about three decimal digits), and the delta-maintained
    running averages of the SAGA-type solvers keep such an error
    forever: SAGA on the planted 262,144 × 1,024 Lasso floored at
    rel 1.1e-3 on an H100 without it. The row passes are bandwidth-
    bound matrix-vector products, so exact f32 costs no time."""
    def pinned(fn):
        @functools.wraps(fn)
        def method(*args, **kwargs):
            with jax.default_matmul_precision("highest"):
                return fn(*args, **kwargs)
        return method

    for name, attr in list(vars(cls).items()):
        if not name.startswith("__") and inspect.isfunction(attr):
            setattr(cls, name, pinned(attr))
    return cls


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


_STORAGE_DTYPES = {
    "bf16": jnp.bfloat16, "bfloat16": jnp.bfloat16,
    "int8": jnp.int8, "i8": jnp.int8,
    "f32": jnp.float32, "float32": jnp.float32, "fp32": jnp.float32,
}


def parse_storage_dtype(dtype):
    """Resolve a ``with_storage`` argument (dtype or alias string) to a
    jnp dtype, with a helpful error for unknown modes."""
    if isinstance(dtype, str):
        try:
            return _STORAGE_DTYPES[dtype]
        except KeyError:
            raise ValueError(
                f"unknown storage mode {dtype!r}; supported: "
                f"{sorted(_STORAGE_DTYPES)} (or a jnp dtype)"
            ) from None
    return dtype


def quantize_rows(A):
    """Symmetric per-row int8 quantization of a real (N, n) row stack.

    Returns ``(q, row_scale)`` with ``q ∈ [-127, 127]`` int8 and f32
    ``row_scale`` such that ``a_i ≈ row_scale_i · q_i`` (absmax
    scaling; all-zero rows get scale 1 so they stay exactly zero).
    int8 → bf16/f32 conversion is exact, so downstream matmul paths see
    the SAME perturbed operator regardless of compute precision.
    """
    rs = jnp.max(jnp.abs(A), axis=1).astype(jnp.float32) / 127.0
    rs = jnp.where(rs > 0, rs, 1.0)
    q = jnp.clip(
        jnp.rint(A.astype(jnp.float32) / rs[:, None]), -127, 127
    ).astype(jnp.int8)
    return q, rs


class SmoothOracle(abc.ABC):
    """Protocol for a finite family ``{f_i}_{i=1..N}`` of smooth terms.

    Subclasses must define ``N`` (number of terms) and ``dim`` (dimension
    of the evaluation point) and implement ``value_and_grad_i``.  All
    batched entry points have generic implementations via ``vmap``;
    subclasses override them when a matmul path exists.
    """

    #: True when every gradient is coordinatewise in x — coordinate j of
    #: ``grad f_i(x)`` depends only on ``x[j]`` (diagonal quadratics, box
    #: distances, sums thereof). Such oracles evaluate correct LOCAL
    #: gradient columns on a coordinate shard with NO collective, which
    #: is what the tensor-parallel sharing path (``parallel.TPProshi``)
    #: requires. Row oracles (least-squares/logistic margins) are NOT:
    #: their gradients go through the full row dot ``a_i·x``.
    coordinate_separable: bool = False

    # --- required -----------------------------------------------------
    @property
    @abc.abstractmethod
    def num_terms(self) -> int:
        ...

    @abc.abstractmethod
    def value_and_grad_i(self, x: jax.Array, i: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Return ``(f_i(x), grad f_i(x))`` for a single (traced) index i."""
        ...

    # --- derived ------------------------------------------------------
    def value_i(self, x: jax.Array, i: jax.Array) -> jax.Array:
        return self.value_and_grad_i(x, i)[0]

    def grad_i(self, x: jax.Array, i: jax.Array) -> jax.Array:
        return self.value_and_grad_i(x, i)[1]

    def value_and_grad_batch(self, x, idx):
        """``(vals[B], grads[B, n])`` — all terms in idx evaluated at x."""
        return jax.vmap(lambda j: self.value_and_grad_i(x, j))(idx)

    def grad_batch(self, x, idx):
        return self.value_and_grad_batch(x, idx)[1]

    def grad_sum_batch(self, x, idx, mask=None):
        """Sum of grads over the index batch; ``mask`` zeroes padded slots."""
        g = self.grad_batch(x, idx)
        if mask is not None:
            g = jnp.where(mask[:, None], g, 0)
        return jnp.sum(g, axis=0)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        """``sum_{i in idx} grad f_i(x1) - grad f_i(x2)``."""
        return self.grad_sum_batch(x1, idx, mask) - self.grad_sum_batch(x2, idx, mask)

    def grad_all(self, x):
        """Per-sample gradients of ALL terms: ``(N, n)`` (table init)."""
        return self.grad_batch(x, jnp.arange(self.num_terms))

    def value_and_grad_all(self, x):
        return self.value_and_grad_batch(x, jnp.arange(self.num_terms))

    def grad_sum_all(self, x):
        """Full-pass gradient sum (SVRG anchor / init); override with matmul."""
        return jnp.sum(self.grad_all(x), axis=0)

    def value_sum_all(self, x):
        """``Σ_i f_i(x)`` — the value-only full pass (adaptive PANOC's
        γ-backtracking probe: one margin read, no gradient). Row
        oracles override to skip the gradient entirely."""
        return self.value_sum_and_grad_sum_all(x)[0]

    def value_sum_and_grad_sum_all(self, x):
        """``(Σ_i f_i(x), Σ_i ∇f_i(x))`` in one full pass — the
        line-search primitive of the Newton-type deterministic solvers
        (PANOC/ZeroFPR FBE evaluations): row-structured overrides
        compute both reductions from the SAME streamed margin, with no
        (N, n) gradient intermediate."""
        vals, grads = self.value_and_grad_all(x)
        return jnp.sum(vals), jnp.sum(grads, axis=0)

    def grad_pointwise(self, xs, idx):
        """Per-sample grads with per-sample eval points: xs is (B, n)."""
        return jax.vmap(lambda xi, j: self.value_and_grad_i(xi, j)[1])(xs, idx)

    def value_and_grad_pointwise(self, xs, idx):
        return jax.vmap(lambda xi, j: self.value_and_grad_i(xi, j))(xs, idx)

    # --- contiguous-block entry points --------------------------------
    # The reference's cyclic/shuffled sweeps pick STATIC CONTIGUOUS
    # index blocks (Finito_basic.jl:50-58), which map to dynamic slices
    # instead of row gathers and scatters. Subclasses with stacked data
    # override these with lax.dynamic_slice reads.

    def grad_block(self, x, start, size: int):
        """grads of terms [start, start+size) at x — contiguous block."""
        return self.grad_batch(x, start + jnp.arange(size, dtype=jnp.int32))

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        idx = start + jnp.arange(size, dtype=jnp.int32)
        return self.grad_sum_diff(x1, x2, idx)

    def grad_pointwise_block(self, xs, start, size: int):
        return self.grad_pointwise(xs, start + jnp.arange(size, dtype=jnp.int32))


def _real_dtype(dtype) -> Any:
    return jnp.finfo(dtype).dtype if jnp.issubdtype(dtype, jnp.floating) else jnp.zeros((), dtype).real.dtype

"""Poisson-regression rows — the count-data GLM (BEYOND the
reference; ProximalOperators.jl has no Poisson likelihood, so the
reference cannot express count regression at all, SURVEY.md §1 L1).

    f_i(x) = scale · (exp(a_iᵀx) − y_i · a_iᵀx)

— the Poisson negative log-likelihood with the canonical log link
(up to the x-independent log(y_i!)), y_i ∈ {0, 1, 2, …} counts. With
g = NormL1 this is sparse Poisson regression (log-linear models,
spike-count data); with g = Zero plain GLM fitting. The gradient is
rank-1,

    ∇f_i(x) = c_i·a_i,   c_i = scale·(exp(a_iᵀx) − y_i),

so the (N,) coefficient table applies — MODE_POISSON in the
coefficient formulas of ``oracles.coeff``. The per-row PROX
(Point-SAGA) is a 1-D monotone-concave Newton solve (like logistic).

**Clamped link.** exp is unbounded, so the loss this oracle defines is
the C¹ LINEAR EXTENSION past margin M = ``POISSON_CLAMP`` (= 30):

    value(m) = exp(m) − y·m        for m ≤ M,
               e^M·(1 + m − M) − y·m   beyond,
    coeff(m) = exp(min(m, M)) − y.

The pair is consistent (coeff = d value/dm everywhere), exp never
overflows f32, and the clamp is shared through ``oracles.coeff`` so the
oracle and the block-step kernel compute the IDENTICAL function. Any
margin that large means the model is diverging anyway (rate e^30 ≈ 10¹³); the extension keeps gradients finite so the
solver can walk back.

There is no global Lipschitz modulus (the Hessian w.r.t. the margin is
exp(m), unbounded): pass per-row moduli from a trust region you pick —
``local_smoothness(m_max)`` gives scale·e^{m_max}·‖a_i‖² — or use the
adaptive (backtracking) Finito variant, which needs no L at all.

Structure mirrors :class:`ciao_tpu.oracles.SquaredHingeRows`
(margin-based formulas parameterizing the dense-rows protocol).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ciao_tpu.oracles.base import (
    highest_precision,
    parse_storage_dtype,
    quantize_rows,
    register_oracle,
    SmoothOracle,
)
from ciao_tpu.oracles.coeff import MODE_POISSON, POISSON_CLAMP


@highest_precision
@register_oracle
@dataclasses.dataclass(frozen=True)
class PoissonRows(SmoothOracle):
    A: jnp.ndarray  # (N, n) feature rows
    y: jnp.ndarray  # (N,) nonnegative counts
    scale: jnp.ndarray = 1.0   # per-term scale
    row_scale: Optional[jnp.ndarray] = None  # (N,) int8 dequant scales

    @property
    def num_terms(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    def with_storage(self, dtype=jnp.bfloat16):
        """Copy with the rows STORED in ``dtype`` (cf.
        ``LeastSquaresRows.with_storage``)."""
        dtype = parse_storage_dtype(dtype)
        if self.row_scale is not None:
            raise ValueError("rows are already int8-quantized")
        if jnp.dtype(dtype) == jnp.int8:
            q, rs = quantize_rows(self.A)
            return dataclasses.replace(self, A=q, row_scale=rs)
        return dataclasses.replace(self, A=self.A.astype(dtype))

    def local_smoothness(self, m_max: float):
        """(N,) per-row smoothness moduli valid while |a_iᵀx| ≤ m_max:
        L_i = scale·e^{m_max}·‖a_i‖² (the margin Hessian is exp(m)).
        Feed these to the solvers' ``L=``; the adaptive Finito variant
        needs none."""
        Ad = self._dense_all(jnp.float32)
        return self.scale * jnp.exp(m_max) * jnp.sum(Ad * Ad, axis=1)

    # ---- dense row access with optional dequant ----------------------
    def _rows_idx(self, idx, dtype):
        A_B = self.A[idx]
        if self.row_scale is not None:
            A_B = A_B.astype(dtype) * self.row_scale[idx][:, None]
        return A_B

    def _slice(self, start, size):
        A_B = jax.lax.dynamic_slice_in_dim(self.A, start, size, 0)
        y_B = jax.lax.dynamic_slice_in_dim(self.y, start, size, 0)
        return A_B, y_B

    def _slice_rs(self, start, size):
        if self.row_scale is None:
            return None
        return jax.lax.dynamic_slice_in_dim(self.row_scale, start, size, 0)

    def _coeff_from_margin(self, m, y):
        """c = scale·(exp(min(m, M)) − y) — the rank-1 coefficient."""
        return self.scale * (jnp.exp(jnp.minimum(m, POISSON_CLAMP)) - y)

    def _val_from_margin(self, m, y):
        M = POISSON_CLAMP
        e = jnp.where(m <= M, jnp.exp(jnp.minimum(m, M)),
                      jnp.exp(M) * (1.0 + (m - M)))
        return self.scale * (e - y * m)

    # ---- per-index / batch / full oracle calls ------------------------
    def value_and_grad_i(self, x, i):
        a = self.A[i]
        if self.row_scale is not None:
            a = a.astype(x.dtype) * self.row_scale[i]
        m = jnp.dot(a, x)
        return (self._val_from_margin(m, self.y[i]),
                self._coeff_from_margin(m, self.y[i]) * a)

    def value_and_grad_batch(self, x, idx):
        A_B = self._rows_idx(idx, x.dtype)
        m = A_B @ x
        y_B = self.y[idx]
        return (self._val_from_margin(m, y_B),
                self._coeff_from_margin(m, y_B)[:, None] * A_B)

    def grad_sum_batch(self, x, idx, mask=None):
        A_B = self._rows_idx(idx, x.dtype)
        c = self._coeff_from_margin(A_B @ x, self.y[idx])
        if mask is not None:
            c = jnp.where(mask, c, 0)
        return c @ A_B

    def _margin_all(self, x):
        if self.row_scale is not None:
            return (self.A.astype(x.dtype) @ x) * self.row_scale
        return self.A @ x

    def grad_sum_all(self, x):
        c = self._coeff_from_margin(self._margin_all(x), self.y)
        if self.row_scale is not None:
            return (c * self.row_scale) @ self.A.astype(x.dtype)
        return c @ self.A

    def value_sum_all(self, x):
        # ONE margin pass, no back-projection (adaptive PANOC γ-probe)
        return self.value_from_margin_all(self.margin_all(x))

    def value_sum_and_grad_sum_all(self, x):
        # both reductions from ONE streamed margin (PANOC line search)
        m = self._margin_all(x)
        c = self._coeff_from_margin(m, self.y)
        val = jnp.sum(self._val_from_margin(m, self.y))
        if self.row_scale is not None:
            return val, (c * self.row_scale) @ self.A.astype(x.dtype)
        return val, c @ self.A

    def _dense_all(self, dtype):
        if self.row_scale is not None:
            return self.A.astype(dtype) * self.row_scale[:, None]
        return self.A

    def grad_all(self, x):
        Ad = self._dense_all(x.dtype)
        return self._coeff_from_margin(Ad @ x, self.y)[:, None] * Ad

    def value_and_grad_all(self, x):
        Ad = self._dense_all(x.dtype)
        m = Ad @ x
        return (self._val_from_margin(m, self.y),
                self._coeff_from_margin(m, self.y)[:, None] * Ad)

    def grad_pointwise(self, xs, idx):
        A_B = self._rows_idx(idx, xs.dtype)
        m = jnp.sum(A_B * xs, axis=-1)
        return self._coeff_from_margin(m, self.y[idx])[:, None] * A_B

    def value_and_grad_pointwise(self, xs, idx):
        A_B = self._rows_idx(idx, xs.dtype)
        m = jnp.sum(A_B * xs, axis=-1)
        y_B = self.y[idx]
        return (self._val_from_margin(m, y_B),
                self._coeff_from_margin(m, y_B)[:, None] * A_B)

    # ---- coefficient (rank-1) structure -------------------------------
    # the clamped link is the MODE_POISSON coefficient formula, so these
    # rows serve every coefficient path LeastSquaresRows does

    supports_coeff: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )
    coeff_mode = MODE_POISSON

    def coeff_rows_data(self):
        """(rows, counts) consumed by the Hopper block-step kernel."""
        return self.A, self.y

    def coeff_rows_scale(self):
        return self.row_scale

    def coeff_batch(self, x, idx):
        A_B = self.A[idx]
        if self.row_scale is not None:
            m = (A_B.astype(x.dtype) @ x) * self.row_scale[idx]
        else:
            m = A_B @ x
        return self._coeff_from_margin(m, self.y[idx])

    def coeff_block(self, x, start, size: int):
        A_B, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        m = (A_B.astype(x.dtype) @ x) * rs_B if rs_B is not None else A_B @ x
        return self._coeff_from_margin(m, y_B)

    def coeff_all(self, x):
        return self._coeff_from_margin(self._margin_all(x), self.y)

    def apply_rows(self, w, idx):
        if self.row_scale is not None:
            return (w * self.row_scale[idx]) @ self.A[idx].astype(w.dtype)
        return w @ self.A[idx]

    def apply_rows_block(self, w, start, size: int):
        A_B, _ = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            return (w * rs_B) @ A_B.astype(w.dtype)
        return w @ A_B

    def apply_all(self, w):
        if self.row_scale is not None:
            return (w * self.row_scale) @ self.A.astype(w.dtype)
        return w @ self.A

    # ---- margin/coeff split (tensor-parallel column sharding) --------
    def margin_block(self, x, start, size: int):
        A_B, _ = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(x.dtype)
        return A_B @ x

    def margin_all(self, x):
        A = self.A.astype(x.dtype) if self.row_scale is not None else self.A
        return A @ x

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """(N,) margin curvature d²f_i/dm² = scale·e^{min(m, CLAMP)}
        evaluated at the anchor margins ``r``, inflated by
        ``margin_slack``: the bound is valid while each margin moves by
        at most ``margin_slack`` — a TRUST-REGION weight (exp is
        unbounded, there is no useful global bound; see
        ``local_smoothness``). The deep-accuracy polish runs AFTER a
        globally-convergent stochastic stage, where the anchor is near
        the optimum and a small slack (~0.5) covers the polish's whole
        trajectory; ``fista_polish``'s monotone restart guards the
        remainder."""
        m = r + jnp.asarray(margin_slack, r.dtype)
        return self.scale * jnp.exp(jnp.minimum(m, POISSON_CLAMP))

    def coeff_from_margin(self, r, start, size: int):
        _, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            r = r * rs_B
        return self._coeff_from_margin(r, y_B)

    def coeff_from_margin_all(self, r):
        if self.row_scale is not None:
            r = r * self.row_scale
        return self._coeff_from_margin(r, self.y)

    def value_from_margin_all(self, r):
        """Σ_i f_i from the raw margins Ax (TP PANOC's FBE)."""
        if self.row_scale is not None:
            r = r * self.row_scale
        return jnp.sum(self._val_from_margin(r, self.y))

    # ---- proximal-point structure (Point-SAGA) ------------------------
    # prox of one row solves θ = scale·(exp(min(m_z − γ‖a‖²θ, M)) − y):
    # φ(θ) = θ − c(θ) is increasing AND concave (φ' ≥ 1), so Newton is
    # globally convergent; 20 steps from the warm start θ₀ = table
    # coefficient (same contract as LogisticRows.pointprox_*).

    supports_pointprox = True

    def _pointprox_core(self, A_B, y_B, rs_B, v, c_B, gamma):
        if rs_B is not None:
            Ad = A_B.astype(v.dtype)
            mv = (Ad @ v) * rs_B
            na2 = jnp.sum(Ad * Ad, axis=1) * (rs_B * rs_B)
        else:
            mv = A_B @ v
            na2 = jnp.sum(A_B * A_B, axis=1)
        mz = mv + gamma * c_B * na2
        theta = _poisson_pointprox_theta(mz, y_B, gamma * na2, c_B,
                                         self.scale)
        w = c_B - theta
        if rs_B is not None:
            u = (w * rs_B) @ A_B.astype(w.dtype)
        else:
            u = w @ A_B
        return theta, u

    def pointprox_block(self, v, c_B, gamma, start, size: int):
        A_B, y_B = self._slice(start, size)
        return self._pointprox_core(A_B, y_B, self._slice_rs(start, size),
                                    v, c_B, gamma)

    def pointprox_batch(self, v, c_B, gamma, idx):
        rs_B = None if self.row_scale is None else self.row_scale[idx]
        return self._pointprox_core(self.A[idx], self.y[idx], rs_B,
                                    v, c_B, gamma)

    def pointprox_sqnorm_block(self, start, size: int):
        A_B, _ = self._slice(start, size)
        if self.row_scale is not None:
            Ad = A_B.astype(jnp.float32)
            return jnp.sum(Ad * Ad, axis=1)
        return jnp.sum(A_B * A_B, axis=1)

    def pointprox_theta_block(self, m_raw, na2_raw, c_B, gamma, start,
                              size: int):
        """θ from the RAW (un-descaled) margins/sqnorms — the
        margin-split Point-SAGA piece TPPointSAGA consumes (cf.
        LogisticRows.pointprox_theta_block)."""
        _, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            m_raw = m_raw * rs_B
            na2_raw = na2_raw * (rs_B * rs_B)
        mz = m_raw + gamma * c_B * na2_raw
        return _poisson_pointprox_theta(mz, y_B, gamma * na2_raw, c_B,
                                        self.scale)

    # ---- contiguous-block fast paths (dynamic-slice DMA, no gather) --
    def grad_block(self, x, start, size: int):
        A_B, y_B = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(x.dtype) * self._slice_rs(start, size)[:, None]
        return self._coeff_from_margin(A_B @ x, y_B)[:, None] * A_B

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        A_B, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            Ad = A_B.astype(x1.dtype)
            c1 = self._coeff_from_margin((Ad @ x1) * rs_B, y_B)
            c2 = self._coeff_from_margin((Ad @ x2) * rs_B, y_B)
            return ((c1 - c2) * rs_B) @ Ad
        c1 = self._coeff_from_margin(A_B @ x1, y_B)
        c2 = self._coeff_from_margin(A_B @ x2, y_B)
        return (c1 - c2) @ A_B

    def grad_pointwise_block(self, xs, start, size: int):
        A_B, y_B = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(xs.dtype) * self._slice_rs(start, size)[:, None]
        m = jnp.sum(A_B * xs, axis=-1)
        return self._coeff_from_margin(m, y_B)[:, None] * A_B


def _poisson_pointprox_theta(mz, y_B, gna2, theta0, scale, iters: int = 20):
    """Solve θ = scale·(exp(min(mz − gna2·θ, M)) − y) per row by Newton
    (φ increasing concave, φ' ≥ 1 — globally convergent; the clamp
    keeps exp finite in f32)."""
    M = POISSON_CLAMP

    def body(_, th):
        u = mz - gna2 * th
        e = jnp.exp(jnp.minimum(u, M))
        phi = th - scale * (e - y_B)
        dphi = 1.0 + scale * gna2 * jnp.where(u <= M, e, 0.0)
        return th - phi / dphi

    return jax.lax.fori_loop(0, iters, body, theta0)

"""Squared-hinge rows — smooth SVM classification (BEYOND the
reference; its oracle set has no margin loss, ProximalOperators.jl's
``HingeLoss`` is nonsmooth and so outside the reference's smooth-f_i
contract, SURVEY.md §0).

    f_i(x) = (scale/2) · max(0, 1 − y_i · a_iᵀx)²

— the standard L2-SVM loss: smooth (C¹, piecewise-quadratic) with
modulus L_i = scale·‖a_i‖², so EVERY finite-sum solver in the framework
trains an SVM; with g = SqrNormL2 it is the classic L2-regularized
L2-SVM, with g = NormL1 a sparse SVM. The gradient is rank-1,

    ∇f_i(x) = c_i·a_i,   c_i = −scale·y_i·max(0, 1 − y_i·a_iᵀx),

so the (N,) coefficient table applies — the clamp is the MODE_SQHINGE
coefficient formula, and the squared-hinge SAGA/Katyusha/SSNM steps
move the same bytes as least squares. The per-row PROX (Point-SAGA) is
closed-form: the hinge is active iff y·m_z < 1, giving
θ = −scale·y·(1−y·m_z)/(1 + scale·γ‖a‖²) on the active side, 0 off it.

Structure mirrors :class:`ciao_tpu.oracles.HuberRows` (margin-based
formulas parameterize the same dense-rows protocol).
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
from ciao_tpu.oracles.coeff import MODE_SQHINGE


@highest_precision
@register_oracle
@dataclasses.dataclass(frozen=True)
class SquaredHingeRows(SmoothOracle):
    A: jnp.ndarray  # (N, n) feature rows
    y: jnp.ndarray  # (N,) labels in {-1, +1}
    scale: jnp.ndarray = 1.0   # per-term scale (the SVM "C")
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

    def _hinge(self, m, y):
        """max(0, 1 − y·m) — the active margin deficit."""
        return jnp.maximum(1.0 - y * m, 0.0)

    def _coeff_from_margin(self, m, y):
        """c = −scale·y·max(0, 1 − y·m) — the rank-1 coefficient."""
        return -self.scale * y * self._hinge(m, y)

    def _val_from_margin(self, m, y):
        h = self._hinge(m, y)
        return 0.5 * self.scale * h * h

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
    # the clamp is the MODE_SQHINGE coefficient formula, so these rows
    # serve every coefficient path LeastSquaresRows does

    supports_coeff: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )
    coeff_mode = MODE_SQHINGE

    def coeff_rows_data(self):
        """(rows, labels) consumed by the Hopper block-step kernel."""
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
        """POINTWISE trust-region bound on the margin curvature
        (round 5 — was the global ``scale``): the active branch
        (y·m < 1) has d²/dm² = scale, the satisfied branch 0, so the
        interval max over |m − rᵢ| ≤ ``margin_slack`` is
        scale·1{yᵢ·rᵢ < 1 + slack} — confidently-classified rows
        contribute no curvature near a separated optimum."""
        act = (self.y * r < 1.0 + margin_slack)
        return jnp.asarray(self.scale, r.dtype) * act.astype(r.dtype)

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
    # prox of one row solves θ = −scale·y·max(0, 1 − y(m_z − γ‖a‖²θ));
    # the hinge is ACTIVE exactly when y·m_z < 1 (the activity of the
    # fixed point matches the activity at m_z — substitute back), giving
    # the closed form θ = −scale·y·(1−y·m_z)/(1 + scale·γ‖a‖²) there
    # and 0 otherwise.

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
        deficit = 1.0 - y_B * mz
        theta = jnp.where(
            deficit > 0,
            -self.scale * y_B * deficit / (1.0 + self.scale * gamma * na2),
            0.0,
        )
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
        LeastSquaresRows.pointprox_theta_block): the same closed-form
        activity split as _pointprox_core."""
        _, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            m_raw = m_raw * rs_B
            na2_raw = na2_raw * (rs_B * rs_B)
        mz = m_raw + gamma * c_B * na2_raw
        deficit = 1.0 - y_B * mz
        return jnp.where(
            deficit > 0,
            -self.scale * y_B * deficit
            / (1.0 + self.scale * gamma * na2_raw),
            0.0,
        )

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

"""Row-wise Huber-loss oracle (robust regression — beyond the
reference's oracle set, same protocol).

    f_i(x) = scale · H_δ(a_i·x − b_i),
    H_δ(r) = r²/2            for |r| ≤ δ
           = δ·(|r| − δ/2)   otherwise

    ∇f_i(x) = scale · clip(a_i·x − b_i, −δ, δ) · a_i

The gradient is RANK-1 with scalar coefficient
c_i(x) = scale·clip(margin − b_i, ±δ), so the whole coefficient-table
machinery (``table="auto"`` solvers, TP margin/coeff split, storage
modes) applies exactly as for :class:`LeastSquaresRows`. The clip is
the ``oracles.coeff.MODE_HUBER`` formula (δ is the kernel's ``aux``
scalar), so this oracle serves every path least-squares rows do.

Smoothness: ∇f_i is scale·‖a_i‖²-Lipschitz (the clip only flattens it),
same L as the least-squares row.
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
from ciao_tpu.oracles.coeff import MODE_HUBER


def _hub_val(r, delta):
    a = jnp.abs(r)
    return jnp.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


@highest_precision
@register_oracle
@dataclasses.dataclass(frozen=True)
class HuberRows(SmoothOracle):
    A: jnp.ndarray  # (N, n) rows
    b: jnp.ndarray  # (N,) targets
    delta: jnp.ndarray = 1.0   # Huber threshold δ (scalar)
    scale: jnp.ndarray = 1.0   # per-term scale (reference convention: N)
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
        b_B = jax.lax.dynamic_slice_in_dim(self.b, start, size, 0)
        return A_B, b_B

    def _slice_rs(self, start, size):
        if self.row_scale is None:
            return None
        return jax.lax.dynamic_slice_in_dim(self.row_scale, start, size, 0)

    def _coeff_from_res(self, r):
        """c = scale·clip(residual, ±δ) — the rank-1 coefficient."""
        return self.scale * jnp.clip(r, -self.delta, self.delta)

    # ---- per-index / batch / full oracle calls ------------------------
    def value_and_grad_i(self, x, i):
        a = self.A[i]
        if self.row_scale is not None:
            a = a.astype(x.dtype) * self.row_scale[i]
        r = jnp.dot(a, x) - self.b[i]
        return self.scale * _hub_val(r, self.delta), self._coeff_from_res(r) * a

    def value_and_grad_batch(self, x, idx):
        A_B = self._rows_idx(idx, x.dtype)
        r = A_B @ x - self.b[idx]
        return self.scale * _hub_val(r, self.delta), \
            self._coeff_from_res(r)[:, None] * A_B

    def grad_sum_batch(self, x, idx, mask=None):
        A_B = self._rows_idx(idx, x.dtype)
        c = self._coeff_from_res(A_B @ x - self.b[idx])
        if mask is not None:
            c = jnp.where(mask, c, 0)
        return c @ A_B

    def _margin_all(self, x):
        if self.row_scale is not None:
            return (self.A.astype(x.dtype) @ x) * self.row_scale
        return self.A @ x

    def grad_sum_all(self, x):
        c = self._coeff_from_res(self._margin_all(x) - self.b)
        if self.row_scale is not None:
            return (c * self.row_scale) @ self.A.astype(x.dtype)
        return c @ self.A

    def value_sum_all(self, x):
        # ONE margin pass, no back-projection (adaptive PANOC γ-probe)
        return self.value_from_margin_all(self.margin_all(x))

    def value_sum_and_grad_sum_all(self, x):
        # both reductions from ONE streamed margin (PANOC line search)
        r = self._margin_all(x) - self.b
        c = self._coeff_from_res(r)
        val = self.scale * jnp.sum(_hub_val(r, self.delta))
        if self.row_scale is not None:
            return val, (c * self.row_scale) @ self.A.astype(x.dtype)
        return val, c @ self.A

    def _dense_all(self, dtype):
        if self.row_scale is not None:
            return self.A.astype(dtype) * self.row_scale[:, None]
        return self.A

    def grad_all(self, x):
        Ad = self._dense_all(x.dtype)
        c = self._coeff_from_res(Ad @ x - self.b)
        return c[:, None] * Ad

    def value_and_grad_all(self, x):
        Ad = self._dense_all(x.dtype)
        r = Ad @ x - self.b
        return self.scale * _hub_val(r, self.delta), \
            self._coeff_from_res(r)[:, None] * Ad

    def grad_pointwise(self, xs, idx):
        A_B = self._rows_idx(idx, xs.dtype)
        r = jnp.sum(A_B * xs, axis=-1) - self.b[idx]
        return self._coeff_from_res(r)[:, None] * A_B

    def value_and_grad_pointwise(self, xs, idx):
        A_B = self._rows_idx(idx, xs.dtype)
        r = jnp.sum(A_B * xs, axis=-1) - self.b[idx]
        return self.scale * _hub_val(r, self.delta), \
            self._coeff_from_res(r)[:, None] * A_B

    # ---- coefficient (rank-1) structure -------------------------------
    # ∇f_i = c_i·a_i with c_i = scale·clip(a_i·x − b_i, ±δ): the (N,)
    # coefficients exactly compress the gradient table. The clip is the
    # MODE_HUBER coefficient formula (δ is the kernel's ``aux`` scalar),
    # so HuberRows serves every path LeastSquaresRows does.

    supports_coeff: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )
    coeff_mode = MODE_HUBER

    def coeff_rows_data(self):
        """(rows, offsets) consumed by the Hopper block-step kernel
        (δ ships separately as the ``aux`` scalar)."""
        return self.A, self.b

    def coeff_rows_scale(self):
        return self.row_scale

    def coeff_batch(self, x, idx):
        A_B = self.A[idx]
        if self.row_scale is not None:
            m = (A_B.astype(x.dtype) @ x) * self.row_scale[idx]
        else:
            m = A_B @ x
        return self._coeff_from_res(m - self.b[idx])

    def coeff_block(self, x, start, size: int):
        A_B, b_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        m = (A_B.astype(x.dtype) @ x) * rs_B if rs_B is not None else A_B @ x
        return self._coeff_from_res(m - b_B)

    def coeff_all(self, x):
        return self._coeff_from_res(self._margin_all(x) - self.b)

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
        (round 5 — was the global ``scale``): H_δ'' = 1 on the
        quadratic branch |m − b| ≤ δ and 0 on the linear tails, so the
        interval max over |m − rᵢ| ≤ ``margin_slack`` is
        scale·1{|rᵢ − bᵢ| ≤ δ + slack} — rows pinned deep in the
        robust (linear) tails contribute no curvature and the polish
        stepsize grows on heavy-outlier data."""
        act = (jnp.abs(r - self.b) <= self.delta + margin_slack)
        return jnp.asarray(self.scale, r.dtype) * act.astype(r.dtype)

    def coeff_from_margin(self, r, start, size: int):
        _, b_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            r = r * rs_B
        return self._coeff_from_res(r - b_B)

    def coeff_from_margin_all(self, r):
        if self.row_scale is not None:
            r = r * self.row_scale
        return self._coeff_from_res(r - self.b)

    def value_from_margin_all(self, r):
        """Σ_i f_i from the raw margins Ax (TP PANOC's FBE)."""
        if self.row_scale is not None:
            r = r * self.row_scale
        return self.scale * jnp.sum(_hub_val(r - self.b, self.delta))

    # ---- contiguous-block fast paths ----------------------------------
    def grad_block(self, x, start, size: int):
        A_B, b_B = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(x.dtype) * self._slice_rs(start, size)[:, None]
        c = self._coeff_from_res(A_B @ x - b_B)
        return c[:, None] * A_B

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        # int8 path mirrors LeastSquaresRows: the clip only needs the
        # SCALAR margins, so the per-row scale touches the (B,) vectors
        # and the raw block feeds both dots — no dequantized (B, n)
        # buffer is ever materialized
        A_B, b_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            Ad = A_B.astype(x1.dtype)
            m1 = (Ad @ x1) * rs_B
            m2 = (Ad @ x2) * rs_B
            c1 = self._coeff_from_res(m1 - b_B)
            c2 = self._coeff_from_res(m2 - b_B)
            return ((c1 - c2) * rs_B) @ Ad
        c1 = self._coeff_from_res(A_B @ x1 - b_B)
        c2 = self._coeff_from_res(A_B @ x2 - b_B)
        return (c1 - c2) @ A_B

    def grad_pointwise_block(self, xs, start, size: int):
        A_B, b_B = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(xs.dtype) * self._slice_rs(start, size)[:, None]
        c = self._coeff_from_res(jnp.sum(A_B * xs, axis=-1) - b_B)
        return c[:, None] * A_B

    # ---- proximal-point structure (Point-SAGA) ------------------------
    # prox of one Huber row solves θ = scale·clip(r_θ, ±δ) with
    # r_θ = (m_z − b) − γ‖a‖²θ. In the quadratic region the fixed point
    # is θ = scale·r₀/(1 + scale·γ‖a‖²) with r₀ = m_z − b; the clipped
    # regions pin θ at ±scale·δ, and the region boundaries line up
    # EXACTLY with clipping that interior solution — one closed form:
    #     θ = clip(scale·r₀/(1 + scale·γ‖a‖²), ±scale·δ).

    supports_pointprox = True

    def _pointprox_core(self, A_B, b_B, rs_B, v, c_B, gamma):
        if rs_B is not None:
            Ad = A_B.astype(v.dtype)
            mv = (Ad @ v) * rs_B
            na2 = jnp.sum(Ad * Ad, axis=1) * (rs_B * rs_B)
        else:
            mv = A_B @ v
            na2 = jnp.sum(A_B * A_B, axis=1)
        mz = mv + gamma * c_B * na2
        r0 = mz - b_B
        theta = jnp.clip(
            self.scale * r0 / (1.0 + self.scale * gamma * na2),
            -self.scale * self.delta, self.scale * self.delta,
        )
        w = c_B - theta
        if rs_B is not None:
            u = (w * rs_B) @ A_B.astype(w.dtype)
        else:
            u = w @ A_B
        return theta, u

    def pointprox_block(self, v, c_B, gamma, start, size: int):
        A_B, b_B = self._slice(start, size)
        return self._pointprox_core(A_B, b_B, self._slice_rs(start, size),
                                    v, c_B, gamma)

    def pointprox_batch(self, v, c_B, gamma, idx):
        rs_B = None if self.row_scale is None else self.row_scale[idx]
        return self._pointprox_core(self.A[idx], self.b[idx], rs_B,
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
        margin-split piece TPPointSAGA consumes."""
        _, b_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            m_raw = m_raw * rs_B
            na2_raw = na2_raw * (rs_B * rs_B)
        mz = m_raw + gamma * c_B * na2_raw
        r0 = mz - b_B
        return jnp.clip(
            self.scale * r0 / (1.0 + self.scale * gamma * na2_raw),
            -self.scale * self.delta, self.scale * self.delta,
        )

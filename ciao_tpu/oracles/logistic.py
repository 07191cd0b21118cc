"""Row-wise logistic-loss oracle family.

Mirrors ``Precompose(LogisticLoss([y_i], 1.0), a_i^T, 1.0)`` per-row
objects used by the reference's L1-logistic tests
(reference ``test/test_logistic_l1.jl:34-41``):

    f_i(x) = log(1 + exp(-y_i <a_i, x>))
    grad f_i(x) = -y_i * sigmoid(-y_i <a_i, x>) * a_i

Stored as a stacked matrix ``X (N, n)`` and labels ``y (N,)`` so batched
paths are matmuls. The Lipschitz modulus of grad f_i is
``0.25 * |a_i|^2`` (test_logistic_l1.jl:40).

Storage modes mirror ``LeastSquaresRows.with_storage``: bf16 rows and
int8 rows with per-row scales (the exact operator becomes
X̃ = diag(row_scale)·Q; the scale commutes with every row-wise product).
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
from ciao_tpu.oracles.coeff import MODE_LOGISTIC


def _log1pexp(t):
    # numerically stable log(1 + exp(t))
    return jnp.logaddexp(0.0, t)


@highest_precision
@register_oracle
@dataclasses.dataclass(frozen=True)
class LogisticRows(SmoothOracle):
    X: jnp.ndarray  # (N, n) features
    y: jnp.ndarray  # (N,) labels in {-1, +1}
    row_scale: Optional[jnp.ndarray] = None  # (N,) int8 dequant scales

    @property
    def num_terms(self) -> int:
        return self.X.shape[0]

    @property
    def dim(self) -> int:
        return self.X.shape[1]

    def with_storage(self, dtype=jnp.bfloat16):
        """Copy with the feature rows STORED in ``dtype`` (see
        ``LeastSquaresRows.with_storage`` — bf16 halves, int8 quarters
        the streaming kernels' HBM traffic; int8 uses symmetric per-row
        scales)."""
        dtype = parse_storage_dtype(dtype)
        if self.row_scale is not None:
            raise ValueError("rows are already int8-quantized")
        if jnp.dtype(dtype) == jnp.int8:
            q, rs = quantize_rows(self.X)
            return dataclasses.replace(self, X=q, row_scale=rs)
        return dataclasses.replace(self, X=self.X.astype(dtype))

    def value_and_grad_i(self, x, i):
        a = self.X[i]
        if self.row_scale is not None:
            a = a.astype(x.dtype) * self.row_scale[i]
        t = -self.y[i] * jnp.dot(a, x)
        val = _log1pexp(t)
        grad = (-self.y[i] * jax.nn.sigmoid(t)) * a
        return val, grad

    def _margins(self, x, idx):
        """(dense_rows, -y·margin) of the gathered batch (int8 rows are
        dequantized per-block; the gather paths materialize (B, n)
        anyway)."""
        X_B = self.X[idx]
        if self.row_scale is not None:
            X_B = X_B.astype(x.dtype) * self.row_scale[idx][:, None]
        t = -self.y[idx] * (X_B @ x)
        return X_B, t

    def value_and_grad_batch(self, x, idx):
        X_B, t = self._margins(x, idx)
        vals = _log1pexp(t)
        coeff = -self.y[idx] * jax.nn.sigmoid(t)
        return vals, coeff[:, None] * X_B

    def grad_sum_batch(self, x, idx, mask=None):
        X_B, t = self._margins(x, idx)
        coeff = -self.y[idx] * jax.nn.sigmoid(t)
        if mask is not None:
            coeff = jnp.where(mask, coeff, 0)
        return coeff @ X_B

    def _margin_all(self, x):
        if self.row_scale is not None:
            return (self.X.astype(x.dtype) @ x) * self.row_scale
        return self.X @ x

    def grad_sum_all(self, x):
        t = -self.y * self._margin_all(x)
        coeff = -self.y * jax.nn.sigmoid(t)
        if self.row_scale is not None:
            return (coeff * self.row_scale) @ self.X.astype(x.dtype)
        return coeff @ self.X

    def value_sum_all(self, x):
        # ONE margin pass, no back-projection (adaptive PANOC γ-probe)
        return self.value_from_margin_all(self.margin_all(x))

    def value_sum_and_grad_sum_all(self, x):
        # both reductions from ONE streamed margin (PANOC line search)
        t = -self.y * self._margin_all(x)
        coeff = -self.y * jax.nn.sigmoid(t)
        val = jnp.sum(_log1pexp(t))
        if self.row_scale is not None:
            return val, (coeff * self.row_scale) @ self.X.astype(x.dtype)
        return val, coeff @ self.X

    def grad_all(self, x):
        if self.row_scale is not None:
            Xd = self.X.astype(x.dtype) * self.row_scale[:, None]
        else:
            Xd = self.X
        t = -self.y * (Xd @ x)
        coeff = -self.y * jax.nn.sigmoid(t)
        return coeff[:, None] * Xd

    def value_and_grad_all(self, x):
        if self.row_scale is not None:
            Xd = self.X.astype(x.dtype) * self.row_scale[:, None]
        else:
            Xd = self.X
        t = -self.y * (Xd @ x)
        coeff = -self.y * jax.nn.sigmoid(t)
        return _log1pexp(t), coeff[:, None] * Xd

    def grad_pointwise(self, xs, idx):
        X_B = self.X[idx]
        if self.row_scale is not None:
            X_B = X_B.astype(xs.dtype) * self.row_scale[idx][:, None]
        t = -self.y[idx] * jnp.sum(X_B * xs, axis=-1)
        coeff = -self.y[idx] * jax.nn.sigmoid(t)
        return coeff[:, None] * X_B

    def value_and_grad_pointwise(self, xs, idx):
        X_B = self.X[idx]
        if self.row_scale is not None:
            X_B = X_B.astype(xs.dtype) * self.row_scale[idx][:, None]
        t = -self.y[idx] * jnp.sum(X_B * xs, axis=-1)
        coeff = -self.y[idx] * jax.nn.sigmoid(t)
        return _log1pexp(t), coeff[:, None] * X_B

    # ---- coefficient (rank-1) gradient structure ---------------------
    # grad f_i(x) = c_i(x) · x_i with SCALAR c_i = −y_i σ(−y_i x_i·x):
    # (N,) coefficients exactly compress the (N, n) gradient table.

    supports_coeff: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )
    coeff_mode = MODE_LOGISTIC

    def coeff_rows_data(self):
        """(rows, labels) consumed by the Hopper block-step kernel."""
        return self.X, self.y

    def coeff_rows_scale(self):
        """(N,) per-row dequant scales for int8 rows; None otherwise."""
        return self.row_scale

    def coeff_batch(self, x, idx):
        X_B = self.X[idx]
        if self.row_scale is not None:
            m = (X_B.astype(x.dtype) @ x) * self.row_scale[idx]
        else:
            m = X_B @ x
        t = -self.y[idx] * m
        return -self.y[idx] * jax.nn.sigmoid(t)

    def coeff_block(self, x, start, size: int):
        X_B, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        m = (X_B.astype(x.dtype) @ x) * rs_B if rs_B is not None else X_B @ x
        return -y_B * jax.nn.sigmoid(-y_B * m)

    def coeff_all(self, x):
        t = -self.y * self._margin_all(x)
        return -self.y * jax.nn.sigmoid(t)

    def apply_rows(self, w, idx):
        if self.row_scale is not None:
            return (w * self.row_scale[idx]) @ self.X[idx].astype(w.dtype)
        return w @ self.X[idx]

    def apply_rows_block(self, w, start, size: int):
        X_B, _ = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            return (w * rs_B) @ X_B.astype(w.dtype)
        return w @ X_B

    def apply_all(self, w):
        if self.row_scale is not None:
            return (w * self.row_scale) @ self.X.astype(w.dtype)
        return w @ self.X

    # margin/coeff split for tensor-parallel column sharding. As in
    # LeastSquaresRows: int8 margins stay un-descaled until
    # coeff_from_margin (the per-row scale is applied after the
    # caller's "model"-axis psum).
    def margin_block(self, x, start, size: int):
        X_B, _ = self._slice(start, size)
        if self.row_scale is not None:
            X_B = X_B.astype(x.dtype)
        return X_B @ x

    def margin_all(self, x):
        X = self.X.astype(x.dtype) if self.row_scale is not None else self.X
        return X @ x

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """POINTWISE trust-region bound on the margin curvature
        d²f_i/dm² = σ(t)(1−σ(t)) over |m − rᵢ| ≤ ``margin_slack``
        (round 5 — was the global 1/4): σ' is even and unimodal with
        peak 1/4 at 0, so the interval max is σ' at the endpoint
        nearest zero, 1/4 if the interval straddles it. Near a
        well-separated optimum the weights sit far below 1/4 and the
        polish stepsize η = 0.9/λ̂ grows accordingly; the anchor is the
        stochastic stage's plateau and ``fista_polish``'s monotone
        restart guards the (tiny) motion outside the region."""
        t = jnp.maximum(jnp.abs(r) - margin_slack, 0.0)
        sg = jax.nn.sigmoid(t)
        return sg * (1.0 - sg)

    def coeff_from_margin(self, r, start, size: int):
        _, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            r = r * rs_B
        return -y_B * jax.nn.sigmoid(-y_B * r)

    def coeff_from_margin_all(self, r):
        if self.row_scale is not None:
            r = r * self.row_scale
        return -self.y * jax.nn.sigmoid(-self.y * r)

    def value_from_margin_all(self, r):
        """Σ_i f_i from the raw margins Xx (TP PANOC's FBE)."""
        if self.row_scale is not None:
            r = r * self.row_scale
        return jnp.sum(_log1pexp(-self.y * r))

    # ---- proximal-point structure (Point-SAGA) ------------------------
    # prox of one logistic row is z − γθ·a_j with the scalar θ solving
    # θ = −y·σ(−y·(m_z − γ|a_j|²θ)) — a 1-D monotone root found by a
    # fixed Newton loop on the margin (no linear algebra). Same
    # (θ_B, Σ(c−θ)a) contract as LeastSquaresRows.pointprox_*.

    supports_pointprox = True

    def _pointprox_core(self, X_B, y_B, rs_B, v, c_B, gamma):
        if rs_B is not None:
            Xd = X_B.astype(v.dtype)
            mv = (Xd @ v) * rs_B
            na2 = jnp.sum(Xd * Xd, axis=1) * (rs_B * rs_B)
        else:
            mv = X_B @ v
            na2 = jnp.sum(X_B * X_B, axis=1)
        mz = mv + gamma * c_B * na2
        theta = _logistic_pointprox_theta(mz, y_B, gamma * na2, c_B)
        w = c_B - theta
        if rs_B is not None:
            u = (w * rs_B) @ X_B.astype(w.dtype)
        else:
            u = w @ X_B
        return theta, u

    def pointprox_block(self, v, c_B, gamma, start, size: int):
        X_B, y_B = self._slice(start, size)
        return self._pointprox_core(X_B, y_B, self._slice_rs(start, size),
                                    v, c_B, gamma)

    def pointprox_batch(self, v, c_B, gamma, idx):
        rs_B = None if self.row_scale is None else self.row_scale[idx]
        return self._pointprox_core(self.X[idx], self.y[idx], rs_B,
                                    v, c_B, gamma)

    # margin-split Point-SAGA pieces for tensor-parallel column
    # sharding (see LeastSquaresRows.pointprox_sqnorm_block).
    def pointprox_sqnorm_block(self, start, size: int):
        X_B, _ = self._slice(start, size)
        if self.row_scale is not None:
            Xd = X_B.astype(jnp.float32)
            return jnp.sum(Xd * Xd, axis=1)
        return jnp.sum(X_B * X_B, axis=1)

    def pointprox_theta_block(self, m_raw, na2_raw, c_B, gamma, start,
                              size: int):
        _, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            m_raw = m_raw * rs_B
            na2_raw = na2_raw * (rs_B * rs_B)
        mz = m_raw + gamma * c_B * na2_raw
        return _logistic_pointprox_theta(mz, y_B, gamma * na2_raw, c_B)

    # ---- contiguous-block fast paths (dynamic-slice DMA, no gather) --
    def _slice(self, start, size):
        X_B = jax.lax.dynamic_slice_in_dim(self.X, start, size, 0)
        y_B = jax.lax.dynamic_slice_in_dim(self.y, start, size, 0)
        return X_B, y_B

    def _slice_rs(self, start, size):
        if self.row_scale is None:
            return None
        return jax.lax.dynamic_slice_in_dim(self.row_scale, start, size, 0)

    def grad_block(self, x, start, size: int):
        X_B, y_B = self._slice(start, size)
        if self.row_scale is not None:
            X_B = X_B.astype(x.dtype) * self._slice_rs(start, size)[:, None]
        t = -y_B * (X_B @ x)
        return (-y_B * jax.nn.sigmoid(t))[:, None] * X_B

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        X_B, y_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            X_B = X_B.astype(x1.dtype) * rs_B[:, None]
        c1 = -y_B * jax.nn.sigmoid(-y_B * (X_B @ x1))
        c2 = -y_B * jax.nn.sigmoid(-y_B * (X_B @ x2))
        return (c1 - c2) @ X_B

    def grad_pointwise_block(self, xs, start, size: int):
        X_B, y_B = self._slice(start, size)
        if self.row_scale is not None:
            X_B = X_B.astype(xs.dtype) * self._slice_rs(start, size)[:, None]
        t = -y_B * jnp.sum(X_B * xs, axis=-1)
        return (-y_B * jax.nn.sigmoid(t))[:, None] * X_B


def _logistic_pointprox_theta(mz, y_B, gna2, theta0, iters: int = 20):
    """Solve θ = −y·σ(−y·(mz − gna2·θ)) per row by Newton (φ' ≥ 1, φ
    monotone increasing — globally convergent; 20 steps reach f64
    roundoff from the warm start θ₀ = table coefficient)."""

    def body(_, th):
        m = mz - gna2 * th
        s = jax.nn.sigmoid(-y_B * m)
        phi = th + y_B * s
        dphi = 1.0 + gna2 * s * (1.0 - s)
        return th - phi / dphi

    return jax.lax.fori_loop(0, iters, body, theta0)

"""Row-wise least-squares oracle family.

Mirrors the capability of ``LeastSquares(A[i:i,:], b[i:i], N)`` per-row
objects used by the reference's Lasso tests
(reference ``test/test_lasso.jl:50-57``):

    f_i(x) = (scale / 2) * |<a_i, x> - b_i|^2
    grad f_i(x) = scale * conj(a_i) * (<a_i, x> - b_i)

but stored as ONE stacked matrix ``A (N, n)`` so every batched path is a
gather + matmul. Complex dtypes supported (the reference test
sweeps ComplexF32/ComplexF64, ``test_lasso.jl:3``).

Storage modes (``with_storage``): bf16 rows (half the HBM traffic) and
int8 rows with per-row symmetric scales (quarter the traffic) — the
row passes are bandwidth-bound, so narrower storage is the main
single-device throughput lever. With quantized rows every path
computes EXACTLY with the perturbed operator Ã = diag(row_scale)·Q, so
kernel/XLA trajectories remain mutually consistent; the per-row
scale commutes with every row-wise product, so no dense dequantized A
is ever materialized on the matvec paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from ciao_tpu.oracles.base import (
    highest_precision,
    parse_storage_dtype,
    quantize_rows,
    register_oracle,
    SmoothOracle,
)
from ciao_tpu.oracles.coeff import MODE_LSQ


@highest_precision
@register_oracle
@dataclasses.dataclass(frozen=True)
class LeastSquaresRows(SmoothOracle):
    A: jnp.ndarray  # (N, n)
    b: jnp.ndarray  # (N,)
    scale: jnp.ndarray  # scalar weight (the reference passes N)
    row_scale: Optional[jnp.ndarray] = None  # (N,) int8 dequant scales

    @property
    def num_terms(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    def _conjA(self):
        return jnp.conj(self.A) if jnp.iscomplexobj(self.A) else self.A

    def with_storage(self, dtype=jnp.bfloat16):
        """Copy with the data rows STORED in ``dtype``. Row passes are
        bandwidth-bound, so narrower row storage converts directly
        into throughput; solver state/iterates stay f32 either way.

        * bf16: half the traffic, gradients accurate to bf16's ~3
          decimal digits — use when the target suboptimality is
          ≳1e-3·cost, or as the middle stage of a staged schedule.
        * int8 (``jnp.int8`` / ``"int8"``): quarter the traffic via
          symmetric per-row quantization ``a_i ≈ row_scale_i · q_i``
          (q ∈ [-127, 127]); ~2.3 correct digits. The coarse first
          stage of an int8→bf16→f32 schedule. Real dtypes only.
        """
        dtype = parse_storage_dtype(dtype)
        if self.row_scale is not None:
            raise ValueError("rows are already int8-quantized")
        if jnp.dtype(dtype) == jnp.int8:
            if jnp.iscomplexobj(self.A):
                raise ValueError("int8 storage requires real rows")
            q, rs = quantize_rows(self.A)
            return dataclasses.replace(self, A=q, row_scale=rs)
        return dataclasses.replace(self, A=self.A.astype(dtype))

    def value_and_grad_i(self, x, i):
        a = self.A[i]
        if self.row_scale is not None:
            a = a.astype(x.dtype) * self.row_scale[i]
        r = jnp.vdot(jnp.conj(a), x) - self.b[i]  # <a, x> - b (no conj on a)
        val = 0.5 * self.scale * jnp.real(r * jnp.conj(r))
        grad = self.scale * jnp.conj(a) * r
        return val, grad

    # ---- batched matmul paths ---------------------------------------
    def _residual(self, x, idx):
        """(dense_rows, residual) of the gathered batch; int8 rows are
        dequantized per-block (the gather paths materialize (B, n)
        blocks regardless)."""
        A_B = self.A[idx]
        if self.row_scale is not None:
            A_B = A_B.astype(x.dtype) * self.row_scale[idx][:, None]
        return A_B, A_B @ x - self.b[idx]

    def value_and_grad_batch(self, x, idx):
        A_B, r = self._residual(x, idx)
        vals = 0.5 * self.scale * jnp.real(r * jnp.conj(r))
        grads = self.scale * jnp.conj(A_B) * r[:, None]
        return vals, grads

    def grad_sum_batch(self, x, idx, mask=None):
        A_B, r = self._residual(x, idx)
        if mask is not None:
            r = jnp.where(mask, r, 0)
        return self.scale * (r @ jnp.conj(A_B))

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        # sum_i grad f_i(x1) - grad f_i(x2) = scale * A_B^H A_B (x1 - x2)
        A_B = self.A[idx]
        if self.row_scale is not None:
            rs = self.row_scale[idx]
            d = (A_B.astype(x1.dtype) @ (x1 - x2)) * rs
            if mask is not None:
                d = jnp.where(mask, d, 0)
            return self.scale * ((d * rs) @ A_B.astype(x1.dtype))
        d = A_B @ (x1 - x2)
        if mask is not None:
            d = jnp.where(mask, d, 0)
        return self.scale * (d @ jnp.conj(A_B))

    def grad_sum_all(self, x):
        if self.row_scale is not None:
            rs = self.row_scale
            r = (self.A.astype(x.dtype) @ x) * rs - self.b
            return self.scale * ((r * rs) @ self.A.astype(x.dtype))
        r = self.A @ x - self.b
        return self.scale * (r @ self._conjA())

    def grad_all(self, x):
        if self.row_scale is not None:
            Ad = self.A.astype(x.dtype) * self.row_scale[:, None]
            r = Ad @ x - self.b
            return self.scale * Ad * r[:, None]
        r = self.A @ x - self.b
        return self.scale * self._conjA() * r[:, None]

    def value_sum_all(self, x):
        # ONE margin pass, no back-projection (adaptive PANOC γ-probe)
        return self.value_from_margin_all(self.margin_all(x))

    def value_sum_and_grad_sum_all(self, x):
        # both reductions from ONE streamed margin (PANOC line search)
        if self.row_scale is not None:
            rs = self.row_scale
            r = (self.A.astype(x.dtype) @ x) * rs - self.b
            val = 0.5 * self.scale * jnp.sum(jnp.real(r * jnp.conj(r)))
            return val, self.scale * ((r * rs) @ self.A.astype(x.dtype))
        r = self.A @ x - self.b
        val = 0.5 * self.scale * jnp.sum(jnp.real(r * jnp.conj(r)))
        return val, self.scale * (r @ self._conjA())

    def value_and_grad_all(self, x):
        if self.row_scale is not None:
            Ad = self.A.astype(x.dtype) * self.row_scale[:, None]
            r = Ad @ x - self.b
            vals = 0.5 * self.scale * jnp.real(r * jnp.conj(r))
            return vals, self.scale * Ad * r[:, None]
        r = self.A @ x - self.b
        vals = 0.5 * self.scale * jnp.real(r * jnp.conj(r))
        return vals, self.scale * self._conjA() * r[:, None]

    def grad_pointwise(self, xs, idx):
        A_B = self.A[idx]
        if self.row_scale is not None:
            A_B = A_B.astype(xs.dtype) * self.row_scale[idx][:, None]
        r = jnp.sum(A_B * xs, axis=-1) - self.b[idx]
        return self.scale * jnp.conj(A_B) * r[:, None]

    # ---- contiguous-block fast paths (dynamic-slice DMA, no gather) --
    def _slice(self, start, size):
        import jax.lax as lax

        A_B = lax.dynamic_slice_in_dim(self.A, start, size, 0)
        b_B = lax.dynamic_slice_in_dim(self.b, start, size, 0)
        return A_B, b_B

    def _slice_rs(self, start, size):
        import jax.lax as lax

        if self.row_scale is None:
            return None
        return lax.dynamic_slice_in_dim(self.row_scale, start, size, 0)

    def grad_block(self, x, start, size: int):
        A_B, b_B = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(x.dtype) * self._slice_rs(start, size)[:, None]
        r = A_B @ x - b_B
        return self.scale * jnp.conj(A_B) * r[:, None]

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        A_B, _ = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            d = (A_B.astype(x1.dtype) @ (x1 - x2)) * rs_B
            return self.scale * ((d * rs_B) @ A_B.astype(x1.dtype))
        d = A_B @ (x1 - x2)
        return self.scale * (d @ jnp.conj(A_B))

    def grad_pointwise_block(self, xs, start, size: int):
        A_B, b_B = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(xs.dtype) * self._slice_rs(start, size)[:, None]
        r = jnp.sum(A_B * xs, axis=-1) - b_B
        return self.scale * jnp.conj(A_B) * r[:, None]

    # ---- coefficient (rank-1) gradient structure ---------------------
    # grad f_i(x) = c_i(x) · conj(a_i) with SCALAR c_i = scale·(a_i·x − b_i):
    # an (N,) coefficient vector is an EXACT compression of the (N, n)
    # gradient table (SURVEY.md §7's recompute-vs-store tradeoff taken to
    # its limit). Solvers in table="coeff" mode store c instead of s —
    # 1/n the memory and half the per-step HBM traffic.

    supports_coeff: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )
    coeff_mode = MODE_LSQ

    def coeff_rows_data(self):
        """(rows, offsets) consumed by the Hopper block-step kernel."""
        return self.A, self.b

    def coeff_rows_scale(self):
        """(N,) per-row dequant scales for int8 rows; None otherwise."""
        return self.row_scale

    def coeff_batch(self, x, idx):
        """c_i(x) for i in idx."""
        A_B = self.A[idx]
        if self.row_scale is not None:
            m = (A_B.astype(x.dtype) @ x) * self.row_scale[idx]
            return self.scale * (m - self.b[idx])
        return self.scale * (A_B @ x - self.b[idx])

    def coeff_block(self, x, start, size: int):
        A_B, b_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            return self.scale * ((A_B.astype(x.dtype) @ x) * rs_B - b_B)
        return self.scale * (A_B @ x - b_B)

    def coeff_all(self, x):
        if self.row_scale is not None:
            return self.scale * (
                (self.A.astype(x.dtype) @ x) * self.row_scale - self.b
            )
        return self.scale * (self.A @ x - self.b)

    def apply_rows(self, w, idx):
        """Σ_i w_i · conj(a_i) over i in idx (the table-delta matvec)."""
        if self.row_scale is not None:
            A_B = self.A[idx]
            return (w * self.row_scale[idx]) @ A_B.astype(w.dtype)
        return w @ jnp.conj(self.A[idx])

    def apply_rows_block(self, w, start, size: int):
        A_B, _ = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            return (w * rs_B) @ A_B.astype(w.dtype)
        return w @ jnp.conj(A_B)

    def apply_all(self, w):
        if self.row_scale is not None:
            return (w * self.row_scale) @ self.A.astype(w.dtype)
        return w @ self._conjA()

    # margin/coeff split for tensor-parallel column sharding: the row
    # product A_B·x is computed on partial columns (then psum'd by the
    # caller) BEFORE the affine/scale part of the coefficient. NOTE:
    # int8 per-row scales do NOT commute with the column split, so the
    # margin of an int8 oracle stays un-descaled here and the scale is
    # applied in coeff_from_margin (after the psum) — callers are
    # unaffected.
    def margin_block(self, x, start, size: int):
        A_B, _ = self._slice(start, size)
        if self.row_scale is not None:
            A_B = A_B.astype(x.dtype)
        return A_B @ x

    def margin_all(self, x):
        A = self.A.astype(x.dtype) if self.row_scale is not None else self.A
        return A @ x

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """Upper bound on the margin curvature d²f_i/dm² near the point
        whose raw margins are ``r`` — constant ``scale`` for least
        squares (GLOBAL and exact; ``margin_slack`` is ignored). Scalar
        or (N,): consumed by :func:`ciao_tpu.solvers.power_lmax`, whose
        power iteration bounds λmax of (1/N)·Aᵀdiag(w)A — the safe
        stepsize source for the deep-accuracy FISTA polish."""
        del margin_slack
        return jnp.real(jnp.asarray(self.scale)).astype(
            jnp.real(r).dtype)

    def coeff_from_margin(self, r, start, size: int):
        _, b_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            r = r * rs_B
        return self.scale * (r - b_B)

    def coeff_from_margin_all(self, r):
        if self.row_scale is not None:
            r = r * self.row_scale
        return self.scale * (r - self.b)

    def value_from_margin_all(self, r):
        """Σ_i f_i from the raw margins Ax (TP PANOC's FBE: the margin
        psums over "model", values reduce over the local row shard)."""
        if self.row_scale is not None:
            r = r * self.row_scale
        res = r - self.b
        return 0.5 * self.scale * jnp.sum(jnp.real(res * jnp.conj(res)))

    def value_and_grad_pointwise(self, xs, idx):
        A_B = self.A[idx]
        if self.row_scale is not None:
            A_B = A_B.astype(xs.dtype) * self.row_scale[idx][:, None]
        r = jnp.sum(A_B * xs, axis=-1) - self.b[idx]
        vals = 0.5 * self.scale * jnp.real(r * jnp.conj(r))
        return vals, self.scale * jnp.conj(A_B) * r[:, None]

    # ---- proximal-point structure (Point-SAGA) ------------------------
    # prox of ONE row term is again rank-1: prox_{γf_j}(z) = z − γθ·conj(a_j)
    # with the SCALAR θ = scale·(a_j·z − b_j)/(1 + γ·scale·|a_j|²) — the
    # closed-form Sherman–Morrison shift. ``pointprox_*`` evaluates, for
    # each row j of a batch, θ_j at z_j = v + γ·c_j·conj(a_j) (c_j the
    # table coefficient) and returns (θ_B, Σ_j (c_j − θ_j)·conj(a_j)),
    # so the whole batched Point-SAGA step is one margin dot + one apply
    # dot over the same streamed rows — byte-identical to the SAGA
    # coefficient step.

    supports_pointprox = True

    def _pointprox_core(self, A_B, b_B, rs_B, v, c_B, gamma):
        if rs_B is not None:
            Ad = A_B.astype(v.dtype)
            mv = (Ad @ v) * rs_B
            na2 = jnp.sum(Ad * Ad, axis=1) * (rs_B * rs_B)
        else:
            mv = A_B @ v
            na2 = jnp.sum(jnp.real(A_B * jnp.conj(A_B)), axis=1)
        mz = mv + gamma * c_B * na2
        theta = self.scale * (mz - b_B) / (1.0 + gamma * self.scale * na2)
        w = c_B - theta
        if rs_B is not None:
            u = (w * rs_B) @ A_B.astype(w.dtype)
        else:
            u = w @ jnp.conj(A_B)
        return theta, u

    def pointprox_block(self, v, c_B, gamma, start, size: int):
        A_B, b_B = self._slice(start, size)
        return self._pointprox_core(A_B, b_B, self._slice_rs(start, size),
                                    v, c_B, gamma)

    def pointprox_batch(self, v, c_B, gamma, idx):
        rs_B = None if self.row_scale is None else self.row_scale[idx]
        return self._pointprox_core(self.A[idx], self.b[idx], rs_B,
                                    v, c_B, gamma)

    # margin-split Point-SAGA pieces for tensor-parallel column
    # sharding: partial row square-norms (un-descaled for int8, like
    # margin_block) are psum'd over "model" by the caller, then the θ
    # solve applies the affine parts after the reduction.
    def pointprox_sqnorm_block(self, start, size: int):
        A_B, _ = self._slice(start, size)
        if self.row_scale is not None:
            Ad = A_B.astype(jnp.float32)
            return jnp.sum(Ad * Ad, axis=1)
        return jnp.sum(jnp.real(A_B * jnp.conj(A_B)), axis=1)

    def pointprox_theta_block(self, m_raw, na2_raw, c_B, gamma, start,
                              size: int):
        _, b_B = self._slice(start, size)
        rs_B = self._slice_rs(start, size)
        if rs_B is not None:
            m_raw = m_raw * rs_B
            na2_raw = na2_raw * (rs_B * rs_B)
        mz = m_raw + gamma * c_B * na2_raw
        return self.scale * (mz - b_B) / (1.0 + gamma * self.scale * na2_raw)

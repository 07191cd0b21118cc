"""Sparse least-squares rows in ELL (padded fixed-nnz) format.

An "rcv1-scale" sparse Lasso (N ~ 1e5..1e7 samples, n ~ 5e4 features,
~0.1 % density) cannot hold a dense (N, n) matrix in device memory, and
the CSR formats CPU codes use do not map to XLA (variable-length rows
defeat static shapes). The static-shape layout is ELL: every row padded
to a fixed ``K`` nonzeros —

    idx (N, K) int32   column indices (padding slots: index 0)
    val (N, K)         values          (padding slots: value 0.0)

so every batched operation is a static-shape gather (z[idx_B]) or
scatter-add; the scatter in ``apply_rows`` touches only B·K elements
per step instead of B·n.

    f_i(x) = (scale / 2) * (<a_i, x> - b_i)^2
    grad f_i(x) = scale * (<a_i, x> - b_i) * a_i      (rank-1: coeff mode)

Design note (the 10M×100 case): when n is SMALL (≲ a few hundred),
dense rows streamed through :class:`LeastSquaresRows` move fewer bytes
than ELL's (index, value) pairs, so sparsity saves nothing there. Use
this class when n is large enough that dense rows don't fit
(n ≳ 1e3 at rcv1-scale N).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ciao_tpu.oracles.base import SmoothOracle, register_oracle, static_field


@register_oracle
@dataclasses.dataclass(frozen=True)
class SparseLeastSquaresELL(SmoothOracle):
    idx: jnp.ndarray     # (N, K) int32 column indices, 0-padded
    val: jnp.ndarray     # (N, K) values, 0.0-padded
    b: jnp.ndarray       # (N,)
    scale: jnp.ndarray   # scalar weight (the reference passes N)
    n_dim: int = static_field(default=0)   # feature dimension n

    @property
    def num_terms(self) -> int:
        return self.idx.shape[0]

    @property
    def dim(self) -> int:
        return self.n_dim

    @property
    def nnz_per_row(self) -> int:
        return self.idx.shape[1]

    @classmethod
    def from_dense(cls, A, b, scale, K: int | None = None):
        """Build from a dense (N, n) matrix (test/bench helper)."""
        import numpy as np

        A = np.asarray(A)
        N, n = A.shape
        nnz = (A != 0).sum(axis=1)
        K = int(K if K is not None else nnz.max())
        idx = np.zeros((N, K), np.int32)
        val = np.zeros((N, K), A.dtype)
        for i in range(N):
            (cols,) = np.nonzero(A[i])
            cols = cols[:K]
            idx[i, : len(cols)] = cols
            val[i, : len(cols)] = A[i, cols]
        return cls(
            idx=jnp.asarray(idx), val=jnp.asarray(val),
            b=jnp.asarray(b), scale=jnp.asarray(scale), n_dim=n,
        )

    # --- single-term (generic fallbacks build on this) ----------------
    def value_and_grad_i(self, x, i):
        r = jnp.sum(self.val[i] * x[self.idx[i]]) - self.b[i]
        vals = 0.5 * self.scale * r * r
        grad = jnp.zeros_like(x).at[self.idx[i]].add(self.scale * r * self.val[i])
        return vals, grad

    # --- sparse margins ----------------------------------------------
    def _slice(self, start, size):
        import jax.lax as lax

        idx_B = lax.dynamic_slice_in_dim(self.idx, start, size, 0)
        val_B = lax.dynamic_slice_in_dim(self.val, start, size, 0)
        b_B = lax.dynamic_slice_in_dim(self.b, start, size, 0)
        return idx_B, val_B, b_B

    @staticmethod
    def _margin(x, idx_B, val_B):
        # (B, K) gather + row-sum: <a_i, x> for each row in the batch
        return jnp.sum(val_B * jnp.take(x, idx_B, axis=0), axis=1)

    # --- coefficient (rank-1) protocol --------------------------------
    supports_coeff: bool = static_field(default=True)
    coeff_mode = 0  # least-squares formula (no dense rows: this class
    #                 deliberately provides no coeff_rows_data)

    def margin_all(self, x):
        """Raw margins <a_i, x> (no scale/offset) — one operator pass;
        with :meth:`apply_all` this is the block-protocol pair the
        margin-weighted curvature power iteration
        (:func:`ciao_tpu.solvers.power_lmax_weighted`) runs on."""
        return self._margin(x, self.idx, self.val)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """Margin curvature d²f_i/dm² = ``scale`` — global and exact
        for least squares (``margin_slack`` ignored)."""
        del margin_slack
        return jnp.asarray(self.scale, r.dtype)

    def coeff_batch(self, x, idx):
        idx_B, val_B, b_B = self.idx[idx], self.val[idx], self.b[idx]
        return self.scale * (self._margin(x, idx_B, val_B) - b_B)

    def coeff_block(self, x, start, size: int):
        idx_B, val_B, b_B = self._slice(start, size)
        return self.scale * (self._margin(x, idx_B, val_B) - b_B)

    def coeff_all(self, x):
        return self.scale * (self._margin(x, self.idx, self.val) - self.b)

    def _apply(self, w, idx_B, val_B):
        # sum_i w_i a_i: scatter-add of B·K weighted values into (n,)
        flat_idx = idx_B.reshape(-1)
        flat_val = (w[:, None] * val_B).reshape(-1)
        return jnp.zeros(self.n_dim, flat_val.dtype).at[flat_idx].add(flat_val)

    def apply_rows(self, w, idx):
        return self._apply(w, self.idx[idx], self.val[idx])

    def apply_rows_block(self, w, start, size: int):
        idx_B, val_B, _ = self._slice(start, size)
        return self._apply(w, idx_B, val_B)

    def apply_all(self, w):
        return self._apply(w, self.idx, self.val)

    # --- batched gradient paths (sparse-aware overrides) --------------
    def grad_sum_all(self, x):
        return self.apply_all(self.coeff_all(x))

    def grad_sum_batch(self, x, idx, mask=None):
        c = self.coeff_batch(x, idx)
        if mask is not None:
            c = jnp.where(mask, c, 0)
        return self.apply_rows(c, idx)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        idx_B, val_B = self.idx[idx], self.val[idx]
        d = self.scale * self._margin(x1 - x2, idx_B, val_B)
        if mask is not None:
            d = jnp.where(mask, d, 0)
        return self._apply(d, idx_B, val_B)

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        idx_B, val_B, _ = self._slice(start, size)
        d = self.scale * self._margin(x1 - x2, idx_B, val_B)
        return self._apply(d, idx_B, val_B)

    def grad_block(self, x, start, size: int):
        # dense (B, n) materialization — full-table mode only; coeff
        # mode (table="auto") never calls this
        idx_B, val_B, b_B = self._slice(start, size)
        c = self.scale * (self._margin(x, idx_B, val_B) - b_B)
        B = idx_B.shape[0]
        rows = jnp.zeros((B, self.n_dim), val_B.dtype)
        return rows.at[jnp.arange(B)[:, None], idx_B].add(c[:, None] * val_B)

    def grad_batch(self, x, idx):
        idx_B, val_B, b_B = self.idx[idx], self.val[idx], self.b[idx]
        c = self.scale * (self._margin(x, idx_B, val_B) - b_B)
        B = idx_B.shape[0]
        rows = jnp.zeros((B, self.n_dim), val_B.dtype)
        return rows.at[jnp.arange(B)[:, None], idx_B].add(c[:, None] * val_B)

    def grad_pointwise(self, xs, idx):
        idx_B, val_B, b_B = self.idx[idx], self.val[idx], self.b[idx]
        c = self.scale * (jnp.sum(val_B * jnp.take_along_axis(
            xs, idx_B, axis=1), axis=1) - b_B)
        B = idx_B.shape[0]
        rows = jnp.zeros((B, self.n_dim), val_B.dtype)
        return rows.at[jnp.arange(B)[:, None], idx_B].add(c[:, None] * val_B)


@register_oracle
@dataclasses.dataclass(frozen=True)
class HybridSparseLeastSquares(SmoothOracle):
    """Hot/cold split sparse least-squares rows — the layout for
    power-law sparse data (rcv1-style doc×term matrices).

    Fine-grained random accesses (gather OR scatter-add) are slower per
    element than a dense row stream, so a pure-ELL oracle is bound by
    its routed elements. The lever is ROUTING FEWER ELEMENTS. Real
    sparse text/feature matrices are power-law: the top-D columns carry
    most of the nnz. Store those columns DENSE (an (N, D) matrix on the
    dense matmul paths) and keep only the tail in ELL with a small K:

        margin_i = <A_hot[i], x[hot_cols]> + Σ_k val[i,k]·x[idx[i,k]] − b_i

    At an 80/20 hot mass split this cuts routed elements ~5x; the dense
    part is ~free by comparison.

    ``hot_cols`` are ORIGINAL column ids (x stays in the original
    feature space; the (D,)-gather x[hot_cols] is negligible). Padding
    conventions: hot_cols padded with 0s whose A_hot column is all-zero;
    ELL padding slots are (index 0, value 0.0) like
    :class:`SparseLeastSquaresELL`."""

    A_hot: jnp.ndarray    # (N, D) dense hot-column values (D lane-padded)
    hot_cols: jnp.ndarray  # (D,) int32 original column ids of the hot part
    idx: jnp.ndarray      # (N, K) int32 cold-column ids, 0-padded
    val: jnp.ndarray      # (N, K) cold values, 0.0-padded
    b: jnp.ndarray        # (N,)
    scale: jnp.ndarray    # scalar weight (the reference passes N)
    n_dim: int = static_field(default=0)

    # hot_cols is (D,) per-FEATURE metadata, not per-term data: keep it
    # replicated under DP even when D happens to equal N
    dp_replicated = ("hot_cols",)

    @property
    def num_terms(self) -> int:
        return self.A_hot.shape[0]

    @property
    def dim(self) -> int:
        return self.n_dim

    @property
    def hot_width(self) -> int:
        return self.A_hot.shape[1]

    @property
    def nnz_per_row(self) -> int:
        return self.idx.shape[1]

    def with_storage(self, dtype=jnp.bfloat16):
        """Copy with the DENSE hot block stored in ``dtype`` (halves the
        dominant HBM stream; the ELL tail stays f32 — it is
        routing-bound, not bandwidth-bound)."""
        return dataclasses.replace(self, A_hot=self.A_hot.astype(dtype))

    @classmethod
    def from_dense(cls, A, b, scale, D: int, K: int | None = None):
        """Split a dense (N, n) matrix: the D columns with the most
        nonzeros go dense, the rest to ELL (test/bench helper; real
        pipelines build the fields directly)."""
        import numpy as np

        A = np.asarray(A)
        N, n = A.shape
        counts = (A != 0).sum(axis=0)
        D_pad = max(128, -(-D // 128) * 128)
        hot = np.argsort(-counts)[:min(D, n)]
        hot_cols = np.zeros(D_pad, np.int32)
        hot_cols[: len(hot)] = hot
        A_hot = np.zeros((N, D_pad), A.dtype)
        A_hot[:, : len(hot)] = A[:, hot]
        cold_mask = np.ones(n, bool)
        cold_mask[hot] = False
        A_cold = A * cold_mask[None, :]
        nnz = (A_cold != 0).sum(axis=1)
        K = int(K if K is not None else max(1, nnz.max()))
        idx = np.zeros((N, K), np.int32)
        val = np.zeros((N, K), A.dtype)
        for i in range(N):
            (cols,) = np.nonzero(A_cold[i])
            cols = cols[:K]
            idx[i, : len(cols)] = cols
            val[i, : len(cols)] = A_cold[i, cols]
        return cls(
            A_hot=jnp.asarray(A_hot), hot_cols=jnp.asarray(hot_cols),
            idx=jnp.asarray(idx), val=jnp.asarray(val),
            b=jnp.asarray(b), scale=jnp.asarray(scale), n_dim=n,
        )

    # --- single-term -------------------------------------------------
    def value_and_grad_i(self, x, i):
        r = (jnp.sum(self.A_hot[i].astype(x.dtype) * x[self.hot_cols])
             + jnp.sum(self.val[i] * x[self.idx[i]]) - self.b[i])
        vals = 0.5 * self.scale * r * r
        grad = jnp.zeros_like(x)
        grad = grad.at[self.hot_cols].add(
            self.scale * r * self.A_hot[i].astype(x.dtype))
        grad = grad.at[self.idx[i]].add(self.scale * r * self.val[i])
        return vals, grad

    # --- internals ----------------------------------------------------
    def _slice(self, start, size):
        import jax.lax as lax

        sl = lambda a: lax.dynamic_slice_in_dim(a, start, size, 0)
        return sl(self.A_hot), sl(self.idx), sl(self.val), sl(self.b)

    def _margin_parts(self, x, Ah_B, idx_B, val_B):
        x_hot = x[self.hot_cols]
        dense = Ah_B.astype(x.dtype) @ x_hot
        cold = jnp.sum(val_B * jnp.take(x, idx_B, axis=0), axis=1)
        return dense + cold

    def _apply_parts(self, w, Ah_B, idx_B, val_B):
        out = jnp.zeros(self.n_dim, w.dtype)
        out = out.at[self.hot_cols].add(
            (w @ Ah_B.astype(w.dtype)))
        flat_idx = idx_B.reshape(-1)
        flat_val = (w[:, None] * val_B).reshape(-1)
        return out.at[flat_idx].add(flat_val)

    # --- coefficient (rank-1) protocol -------------------------------
    supports_coeff: bool = static_field(default=True)
    coeff_mode = 0

    def margin_all(self, x):
        """Raw margins <a_i, x> (hot + cold parts, no scale/offset)."""
        return self._margin_parts(x, self.A_hot, self.idx, self.val)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        del margin_slack
        return jnp.asarray(self.scale, r.dtype)

    def coeff_batch(self, x, idx):
        m = self._margin_parts(x, self.A_hot[idx], self.idx[idx],
                               self.val[idx])
        return self.scale * (m - self.b[idx])

    def coeff_block(self, x, start, size: int):
        Ah_B, idx_B, val_B, b_B = self._slice(start, size)
        return self.scale * (self._margin_parts(x, Ah_B, idx_B, val_B) - b_B)

    def coeff_all(self, x):
        return self.scale * (
            self._margin_parts(x, self.A_hot, self.idx, self.val) - self.b)

    def apply_rows(self, w, idx):
        return self._apply_parts(w, self.A_hot[idx], self.idx[idx],
                                 self.val[idx])

    def apply_rows_block(self, w, start, size: int):
        Ah_B, idx_B, val_B, _ = self._slice(start, size)
        return self._apply_parts(w, Ah_B, idx_B, val_B)

    def apply_all(self, w):
        return self._apply_parts(w, self.A_hot, self.idx, self.val)

    # --- batched gradient paths ---------------------------------------
    def grad_sum_all(self, x):
        return self.apply_all(self.coeff_all(x))

    def grad_sum_batch(self, x, idx, mask=None):
        c = self.coeff_batch(x, idx)
        if mask is not None:
            c = jnp.where(mask, c, 0)
        return self.apply_rows(c, idx)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        Ah_B, idx_B, val_B = self.A_hot[idx], self.idx[idx], self.val[idx]
        d = self.scale * self._margin_parts(x1 - x2, Ah_B, idx_B, val_B)
        if mask is not None:
            d = jnp.where(mask, d, 0)
        return self._apply_parts(d, Ah_B, idx_B, val_B)

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        Ah_B, idx_B, val_B, _ = self._slice(start, size)
        d = self.scale * self._margin_parts(x1 - x2, Ah_B, idx_B, val_B)
        return self._apply_parts(d, Ah_B, idx_B, val_B)

    def _dense_rows(self, c, Ah_B, idx_B, val_B):
        B = idx_B.shape[0]
        rows = jnp.zeros((B, self.n_dim), c.dtype)
        rows = rows.at[:, self.hot_cols].add(
            c[:, None] * Ah_B.astype(c.dtype))
        return rows.at[jnp.arange(B)[:, None], idx_B].add(
            c[:, None] * val_B)

    def grad_block(self, x, start, size: int):
        Ah_B, idx_B, val_B, b_B = self._slice(start, size)
        c = self.scale * (self._margin_parts(x, Ah_B, idx_B, val_B) - b_B)
        return self._dense_rows(c, Ah_B, idx_B, val_B)

    def grad_batch(self, x, idx):
        Ah_B, idx_B, val_B = self.A_hot[idx], self.idx[idx], self.val[idx]
        c = self.scale * (
            self._margin_parts(x, Ah_B, idx_B, val_B) - self.b[idx])
        return self._dense_rows(c, Ah_B, idx_B, val_B)

    def grad_pointwise(self, xs, idx):
        Ah_B, idx_B, val_B = self.A_hot[idx], self.idx[idx], self.val[idx]
        dense = jnp.sum(Ah_B.astype(xs.dtype) * xs[:, self.hot_cols], axis=1)
        cold = jnp.sum(val_B * jnp.take_along_axis(xs, idx_B, axis=1), axis=1)
        c = self.scale * (dense + cold - self.b[idx])
        return self._dense_rows(c, Ah_B, idx_B, val_B)


def _logistic_trust_weight(r, margin_slack=0.0):
    """POINTWISE trust-region bound on the logistic margin curvature
    σ(t)(1−σ(t)) over the interval |m − r| ≤ margin_slack: σ' is even
    and unimodal with peak 1/4 at 0, so the interval max is σ' at the
    endpoint nearest zero — 1/4 if the interval straddles it. Replaces
    the global 1/4 the dense path uses (VERDICT r4 #5): near a
    well-separated optimum the pointwise weights are ≪ 1/4 and the
    polish stepsize η = 0.9/λ̂ grows accordingly (the quadratic-twin ×
    1/4 bound needed a 2× longer FISTA leash)."""
    t = jnp.maximum(jnp.abs(r) - margin_slack, 0.0)
    sg = jax.nn.sigmoid(t)
    return sg * (1.0 - sg)


def _sigmoid_coeff(y_B, m):
    """Logistic rank-1 coefficient c = −y σ(−y·m) from the margin m
    (reference test_logistic_l1.jl:34-41; cf. logistic.LogisticRows)."""
    return -y_B * jax.nn.sigmoid(-y_B * m)


def _log1pexp(t):
    return jnp.logaddexp(0.0, t)


@register_oracle
@dataclasses.dataclass(frozen=True)
class SparseLogisticELL(SmoothOracle):
    """Sparse logistic-loss rows in ELL layout — the sparse counterpart
    of :class:`~ciao_tpu.oracles.LogisticRows` (rcv1-style L1-logistic
    is THE workload this shape exists for: doc×term features at ~0.1 %
    density with ±1 labels):

        f_i(x) = log(1 + exp(-y_i <a_i, x>))
        grad f_i(x) = -y_i σ(-y_i <a_i, x>) a_i     (rank-1: coeff mode)

    Layout and padding conventions are :class:`SparseLeastSquaresELL`'s
    (idx 0 / value 0.0 padding slots; static (N, K) shapes so every
    batched op is a gather or scatter-add). The Lipschitz modulus of
    grad f_i is ``0.25 * |a_i|^2`` (test_logistic_l1.jl:40)."""

    idx: jnp.ndarray     # (N, K) int32 column indices, 0-padded
    val: jnp.ndarray     # (N, K) values, 0.0-padded
    y: jnp.ndarray       # (N,) labels in {-1, +1}
    n_dim: int = static_field(default=0)

    @property
    def num_terms(self) -> int:
        return self.idx.shape[0]

    @property
    def dim(self) -> int:
        return self.n_dim

    @property
    def nnz_per_row(self) -> int:
        return self.idx.shape[1]

    @classmethod
    def from_dense(cls, A, y, K: int | None = None):
        """Build from a dense (N, n) matrix (test/bench helper)."""
        import numpy as np

        A = np.asarray(A)
        N, n = A.shape
        nnz = (A != 0).sum(axis=1)
        K = int(K if K is not None else max(1, nnz.max()))
        idx = np.zeros((N, K), np.int32)
        val = np.zeros((N, K), A.dtype)
        for i in range(N):
            (cols,) = np.nonzero(A[i])
            cols = cols[:K]
            idx[i, : len(cols)] = cols
            val[i, : len(cols)] = A[i, cols]
        return cls(
            idx=jnp.asarray(idx), val=jnp.asarray(val),
            y=jnp.asarray(y), n_dim=n,
        )

    # --- single-term ---------------------------------------------------
    def value_and_grad_i(self, x, i):
        m = jnp.sum(self.val[i] * x[self.idx[i]])
        t = -self.y[i] * m
        c = -self.y[i] * jax.nn.sigmoid(t)
        grad = jnp.zeros_like(x).at[self.idx[i]].add(c * self.val[i])
        return _log1pexp(t), grad

    # --- internals (shared idioms with SparseLeastSquaresELL) ----------
    def _slice(self, start, size):
        import jax.lax as lax

        idx_B = lax.dynamic_slice_in_dim(self.idx, start, size, 0)
        val_B = lax.dynamic_slice_in_dim(self.val, start, size, 0)
        y_B = lax.dynamic_slice_in_dim(self.y, start, size, 0)
        return idx_B, val_B, y_B

    @staticmethod
    def _margin(x, idx_B, val_B):
        return jnp.sum(val_B * jnp.take(x, idx_B, axis=0), axis=1)

    def _apply(self, w, idx_B, val_B):
        flat_idx = idx_B.reshape(-1)
        flat_val = (w[:, None] * val_B).reshape(-1)
        return jnp.zeros(self.n_dim, flat_val.dtype).at[flat_idx].add(flat_val)

    # --- coefficient (rank-1) protocol ----------------------------------
    supports_coeff: bool = static_field(default=True)
    coeff_mode = 1  # logistic formula (no dense rows: no coeff_rows_data)

    def margin_all(self, x):
        """Raw margins <a_i, x> — label-free (the logistic margin
        curvature σ'(y·m) = σ'(m) is even, so the weighted Hessian
        needs no labels)."""
        return self._margin(x, self.idx, self.val)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        return _logistic_trust_weight(r, margin_slack)

    def coeff_batch(self, x, idx):
        m = self._margin(x, self.idx[idx], self.val[idx])
        return _sigmoid_coeff(self.y[idx], m)

    def coeff_block(self, x, start, size: int):
        idx_B, val_B, y_B = self._slice(start, size)
        return _sigmoid_coeff(y_B, self._margin(x, idx_B, val_B))

    def coeff_all(self, x):
        return _sigmoid_coeff(self.y, self._margin(x, self.idx, self.val))

    def apply_rows(self, w, idx):
        return self._apply(w, self.idx[idx], self.val[idx])

    def apply_rows_block(self, w, start, size: int):
        idx_B, val_B, _ = self._slice(start, size)
        return self._apply(w, idx_B, val_B)

    def apply_all(self, w):
        return self._apply(w, self.idx, self.val)

    # --- batched gradient paths -----------------------------------------
    def grad_sum_all(self, x):
        return self.apply_all(self.coeff_all(x))

    def grad_sum_batch(self, x, idx, mask=None):
        c = self.coeff_batch(x, idx)
        if mask is not None:
            c = jnp.where(mask, c, 0)
        return self.apply_rows(c, idx)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        # logistic coefficients are NOT linear in the margin: compute
        # both and difference (cf. LogisticRows.grad_sum_diff_block)
        idx_B, val_B, y_B = self.idx[idx], self.val[idx], self.y[idx]
        c1 = _sigmoid_coeff(y_B, self._margin(x1, idx_B, val_B))
        c2 = _sigmoid_coeff(y_B, self._margin(x2, idx_B, val_B))
        d = c1 - c2
        if mask is not None:
            d = jnp.where(mask, d, 0)
        return self._apply(d, idx_B, val_B)

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        idx_B, val_B, y_B = self._slice(start, size)
        c1 = _sigmoid_coeff(y_B, self._margin(x1, idx_B, val_B))
        c2 = _sigmoid_coeff(y_B, self._margin(x2, idx_B, val_B))
        return self._apply(c1 - c2, idx_B, val_B)

    def _dense_rows(self, c, idx_B, val_B):
        B = idx_B.shape[0]
        rows = jnp.zeros((B, self.n_dim), c.dtype)
        return rows.at[jnp.arange(B)[:, None], idx_B].add(c[:, None] * val_B)

    def grad_block(self, x, start, size: int):
        idx_B, val_B, y_B = self._slice(start, size)
        c = _sigmoid_coeff(y_B, self._margin(x, idx_B, val_B))
        return self._dense_rows(c, idx_B, val_B)

    def grad_batch(self, x, idx):
        idx_B, val_B, y_B = self.idx[idx], self.val[idx], self.y[idx]
        c = _sigmoid_coeff(y_B, self._margin(x, idx_B, val_B))
        return self._dense_rows(c, idx_B, val_B)

    def grad_pointwise(self, xs, idx):
        idx_B, val_B, y_B = self.idx[idx], self.val[idx], self.y[idx]
        m = jnp.sum(val_B * jnp.take_along_axis(xs, idx_B, axis=1), axis=1)
        c = _sigmoid_coeff(y_B, m)
        return self._dense_rows(c, idx_B, val_B)


@register_oracle
@dataclasses.dataclass(frozen=True)
class HybridSparseLogistic(SmoothOracle):
    """Hot/cold split sparse logistic rows — the power-law layout of
    :class:`HybridSparseLeastSquares` (dense hot columns take the dense
    matmul paths; only the tail pays for routed elements) with the
    logistic loss of
    :class:`SparseLogisticELL`:

        margin_i = <A_hot[i], x[hot_cols]> + Σ_k val[i,k]·x[idx[i,k]]
        f_i(x) = log(1 + exp(-y_i margin_i))

    Padding conventions as in the least-squares hybrid."""

    A_hot: jnp.ndarray     # (N, D) dense hot-column values (D lane-padded)
    hot_cols: jnp.ndarray  # (D,) int32 original column ids
    idx: jnp.ndarray       # (N, K) int32 cold-column ids, 0-padded
    val: jnp.ndarray       # (N, K) cold values, 0.0-padded
    y: jnp.ndarray         # (N,) labels in {-1, +1}
    n_dim: int = static_field(default=0)

    dp_replicated = ("hot_cols",)

    @property
    def num_terms(self) -> int:
        return self.A_hot.shape[0]

    @property
    def dim(self) -> int:
        return self.n_dim

    @property
    def hot_width(self) -> int:
        return self.A_hot.shape[1]

    @property
    def nnz_per_row(self) -> int:
        return self.idx.shape[1]

    def with_storage(self, dtype=jnp.bfloat16):
        """Copy with the DENSE hot block stored in ``dtype`` (the ELL
        tail stays full precision — routing-bound, not bandwidth-bound)."""
        return dataclasses.replace(self, A_hot=self.A_hot.astype(dtype))

    @classmethod
    def from_dense(cls, A, y, D: int, K: int | None = None):
        """Split a dense (N, n) matrix like
        ``HybridSparseLeastSquares.from_dense`` (labels instead of b)."""
        import numpy as np

        A = np.asarray(A)
        N, n = A.shape
        counts = (A != 0).sum(axis=0)
        D_pad = max(128, -(-D // 128) * 128)
        hot = np.argsort(-counts)[:min(D, n)]
        hot_cols = np.zeros(D_pad, np.int32)
        hot_cols[: len(hot)] = hot
        A_hot = np.zeros((N, D_pad), A.dtype)
        A_hot[:, : len(hot)] = A[:, hot]
        cold_mask = np.ones(n, bool)
        cold_mask[hot] = False
        A_cold = A * cold_mask[None, :]
        nnz = (A_cold != 0).sum(axis=1)
        K = int(K if K is not None else max(1, nnz.max()))
        idx = np.zeros((N, K), np.int32)
        val = np.zeros((N, K), A.dtype)
        for i in range(N):
            (cols,) = np.nonzero(A_cold[i])
            cols = cols[:K]
            idx[i, : len(cols)] = cols
            val[i, : len(cols)] = A_cold[i, cols]
        return cls(
            A_hot=jnp.asarray(A_hot), hot_cols=jnp.asarray(hot_cols),
            idx=jnp.asarray(idx), val=jnp.asarray(val),
            y=jnp.asarray(y), n_dim=n,
        )

    # --- single-term ----------------------------------------------------
    def value_and_grad_i(self, x, i):
        m = (jnp.sum(self.A_hot[i].astype(x.dtype) * x[self.hot_cols])
             + jnp.sum(self.val[i] * x[self.idx[i]]))
        t = -self.y[i] * m
        c = -self.y[i] * jax.nn.sigmoid(t)
        grad = jnp.zeros_like(x)
        grad = grad.at[self.hot_cols].add(c * self.A_hot[i].astype(x.dtype))
        grad = grad.at[self.idx[i]].add(c * self.val[i])
        return _log1pexp(t), grad

    # --- internals -------------------------------------------------------
    def _slice(self, start, size):
        import jax.lax as lax

        sl = lambda a: lax.dynamic_slice_in_dim(a, start, size, 0)
        return sl(self.A_hot), sl(self.idx), sl(self.val), sl(self.y)

    def _margin_parts(self, x, Ah_B, idx_B, val_B):
        x_hot = x[self.hot_cols]
        dense = Ah_B.astype(x.dtype) @ x_hot
        cold = jnp.sum(val_B * jnp.take(x, idx_B, axis=0), axis=1)
        return dense + cold

    def _apply_parts(self, w, Ah_B, idx_B, val_B):
        out = jnp.zeros(self.n_dim, w.dtype)
        out = out.at[self.hot_cols].add(w @ Ah_B.astype(w.dtype))
        flat_idx = idx_B.reshape(-1)
        flat_val = (w[:, None] * val_B).reshape(-1)
        return out.at[flat_idx].add(flat_val)

    # --- coefficient (rank-1) protocol ------------------------------------
    supports_coeff: bool = static_field(default=True)
    coeff_mode = 1

    def margin_all(self, x):
        return self._margin_parts(x, self.A_hot, self.idx, self.val)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        return _logistic_trust_weight(r, margin_slack)

    def coeff_batch(self, x, idx):
        m = self._margin_parts(x, self.A_hot[idx], self.idx[idx],
                               self.val[idx])
        return _sigmoid_coeff(self.y[idx], m)

    def coeff_block(self, x, start, size: int):
        Ah_B, idx_B, val_B, y_B = self._slice(start, size)
        return _sigmoid_coeff(y_B, self._margin_parts(x, Ah_B, idx_B, val_B))

    def coeff_all(self, x):
        return _sigmoid_coeff(
            self.y, self._margin_parts(x, self.A_hot, self.idx, self.val))

    def apply_rows(self, w, idx):
        return self._apply_parts(w, self.A_hot[idx], self.idx[idx],
                                 self.val[idx])

    def apply_rows_block(self, w, start, size: int):
        Ah_B, idx_B, val_B, _ = self._slice(start, size)
        return self._apply_parts(w, Ah_B, idx_B, val_B)

    def apply_all(self, w):
        return self._apply_parts(w, self.A_hot, self.idx, self.val)

    # --- batched gradient paths --------------------------------------------
    def grad_sum_all(self, x):
        return self.apply_all(self.coeff_all(x))

    def grad_sum_batch(self, x, idx, mask=None):
        c = self.coeff_batch(x, idx)
        if mask is not None:
            c = jnp.where(mask, c, 0)
        return self.apply_rows(c, idx)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        Ah_B, idx_B, val_B = self.A_hot[idx], self.idx[idx], self.val[idx]
        y_B = self.y[idx]
        c1 = _sigmoid_coeff(y_B, self._margin_parts(x1, Ah_B, idx_B, val_B))
        c2 = _sigmoid_coeff(y_B, self._margin_parts(x2, Ah_B, idx_B, val_B))
        d = c1 - c2
        if mask is not None:
            d = jnp.where(mask, d, 0)
        return self._apply_parts(d, Ah_B, idx_B, val_B)

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        Ah_B, idx_B, val_B, y_B = self._slice(start, size)
        c1 = _sigmoid_coeff(y_B, self._margin_parts(x1, Ah_B, idx_B, val_B))
        c2 = _sigmoid_coeff(y_B, self._margin_parts(x2, Ah_B, idx_B, val_B))
        return self._apply_parts(c1 - c2, Ah_B, idx_B, val_B)

    def _dense_rows(self, c, Ah_B, idx_B, val_B):
        B = idx_B.shape[0]
        rows = jnp.zeros((B, self.n_dim), c.dtype)
        rows = rows.at[:, self.hot_cols].add(c[:, None] * Ah_B.astype(c.dtype))
        return rows.at[jnp.arange(B)[:, None], idx_B].add(c[:, None] * val_B)

    def grad_block(self, x, start, size: int):
        Ah_B, idx_B, val_B, y_B = self._slice(start, size)
        c = _sigmoid_coeff(y_B, self._margin_parts(x, Ah_B, idx_B, val_B))
        return self._dense_rows(c, Ah_B, idx_B, val_B)

    def grad_batch(self, x, idx):
        Ah_B, idx_B, val_B = self.A_hot[idx], self.idx[idx], self.val[idx]
        c = _sigmoid_coeff(
            self.y[idx], self._margin_parts(x, Ah_B, idx_B, val_B))
        return self._dense_rows(c, Ah_B, idx_B, val_B)

    def grad_pointwise(self, xs, idx):
        Ah_B, idx_B, val_B = self.A_hot[idx], self.idx[idx], self.val[idx]
        dense = jnp.sum(Ah_B.astype(xs.dtype) * xs[:, self.hot_cols], axis=1)
        cold = jnp.sum(val_B * jnp.take_along_axis(xs, idx_B, axis=1), axis=1)
        c = _sigmoid_coeff(self.y[idx], dense + cold)
        return self._dense_rows(c, Ah_B, idx_B, val_B)

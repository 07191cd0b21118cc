"""Synthetic test problems with planted optima.

Re-creations of the reference's three acceptance problems so tolerances
are directly comparable (SURVEY.md §4):

  * :func:`make_lasso` — Lasso with a KNOWN 2-sparse solution planted by
    column scaling (reference ``test/test_lasso.jl:14-47``). Works at any
    (N, n) scale — also used by the large-scale benchmark harness.
  * :func:`make_logistic_l1` — the 8×5 two-class problem with hardcoded
    x_star (reference ``test/test_logistic_l1.jl:12-29``).
  * :func:`make_sharing` — the N=3, n=2 sharing problem with hardcoded
    coupling optimum (reference ``test/test_sharing.jl:11-28``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LassoProblem(NamedTuple):
    A: np.ndarray        # (N, n)
    b: np.ndarray        # (N,)
    lam: float
    x_star: np.ndarray   # planted solution
    f_star: float        # exact optimal cost
    L: np.ndarray        # (N,) per-row Lipschitz moduli (× N scaling)

    def cost(self, x):
        x = np.asarray(x)
        r = self.A @ x - self.b
        return 0.5 * float(np.real(np.vdot(r, r))) + self.lam * float(
            np.sum(np.abs(x))
        )


def make_lasso(N=6, n=3, p=2, lam=1.0, rho=10.0, seed=0, dtype=np.float64,
               well_conditioned=False):
    """Plant a p-sparse Lasso solution via the KKT conditions.

    Construction (test_lasso.jl:18-42): draw a unit dual vector y*,
    rescale the columns of a random matrix so |A_j^T y*| = λ on the
    support and ≤ λ off it, set x* on the support with matching signs,
    then b = A x* + y*. The optimality conditions hold exactly, so
    f* = cost(x*) needs no reference solver.

    ``well_conditioned=True`` caps every column scale at the largest
    on-support scale (KKT still holds: smaller α_j only shrinks
    |A_j^T y*| below λ). The reference recipe divides by the SMALLEST
    |C_j^T y*| values off-support, which at large n plants columns
    1000× bigger than the rest — κ(AᵀA) explodes and incremental
    methods at reference-default stepsizes stall (~0.1 %/epoch). The
    capped variant keeps the column-norm spread ≲1.5× so convergence
    behaviour, not conditioning, is what a benchmark measures.
    """
    rng = np.random.default_rng(seed)
    rdt = np.zeros((), dtype).real.dtype
    complex_out = np.issubdtype(dtype, np.complexfloating)

    y = rng.random(N).astype(rdt)
    y /= np.linalg.norm(y)
    C = (rng.random((N, n)).astype(rdt) * 2 - 1)
    CTy = np.abs(C.T @ y)
    perm = np.argsort(-CTy)  # decreasing

    alpha = np.zeros(n, rdt)
    if well_conditioned:
        cap = lam / CTy[perm[p - 1]]      # largest on-support scale
        alpha[:] = np.minimum(lam / CTy, cap)
    else:
        for k in range(n):
            j = perm[k]
            if k < p:
                alpha[j] = lam / CTy[j]
            else:
                alpha[j] = (
                    lam if CTy[j] < 0.1 * lam else lam * rng.random() / CTy[j]
                )
    A = C * alpha[None, :]

    x_star = np.zeros(n, rdt)
    for k in range(p):
        j = perm[k]
        x_star[j] = rng.random() * rho / np.sqrt(p) * np.sign(A[:, j] @ y)
    b = A @ x_star + y

    L = (np.sum(np.abs(A) ** 2, axis=1) * N).astype(rdt)  # opnorm(row)^2 * N

    if complex_out:
        A = A.astype(dtype)
        b = b.astype(dtype)
        x_star = x_star.astype(dtype)

    prob = LassoProblem(A=A, b=b, lam=float(lam), x_star=x_star, f_star=0.0, L=L)
    return prob._replace(f_star=prob.cost(x_star))


class DeviceLassoProblem(NamedTuple):
    """A well-conditioned planted Lasso whose arrays live on the device
    (:func:`make_lasso_device`). ``f_star`` is exact up to the f32
    rounding of ``b``, which ``r_star`` carries."""

    A: object            # (N, n) f32, device
    b: object            # (N,) f32, device
    r_star: object       # (N,) A x* − b as computed in f32
    x_star: object       # (n,) planted solution
    L: object            # (N,) per-row moduli (× N scaling)
    lam: float
    f_star: float

    def gap_rel(self, z) -> float:
        """Relative suboptimality (cost(z) − f*)/f* in the difference
        form ½‖u‖² + ⟨u, r*⟩ + λ(‖z‖₁ − ‖x*‖₁), u = A(z − x*): ``b``
        cancels exactly, and the two reductions over the rows carry
        two-sum compensation, so rel 1e-6 is resolved at 10M rows."""
        import jax.numpy as jnp

        import jax

        quad = float(jax.jit(_gap_quad)(self.A, self.x_star, self.r_star,
                                        jnp.asarray(z, jnp.float32)))
        l1 = self.lam * (np.abs(np.asarray(z, np.float64)).sum()
                         - np.abs(np.asarray(self.x_star, np.float64)).sum())
        return (quad + l1) / abs(self.f_star)


def _gap_quad(A, xs, r_star, z):
    import jax
    import jax.numpy as jnp

    from ciao_tpu.solvers.polish import _two_sum

    HI = jax.lax.Precision.HIGHEST
    C = 32_768
    while A.shape[0] % C:
        C //= 2
    dz = z - xs

    def body(carry, i):
        qhi, qlo, phi, plo = carry
        A_B = jax.lax.dynamic_slice_in_dim(A, i * C, C, 0)
        r_B = jax.lax.dynamic_slice_in_dim(r_star, i * C, C, 0)
        u = jnp.dot(A_B, dz, precision=HI)
        qhi, qlo = _two_sum(qhi, qlo, 0.5 * jnp.vdot(u, u, precision=HI))
        phi, plo = _two_sum(phi, plo, jnp.vdot(u, r_B, precision=HI))
        return (qhi, qlo, phi, plo), None

    z0 = jnp.zeros((), jnp.float32)
    (qhi, qlo, phi, plo), _ = jax.lax.scan(
        body, (z0, z0, z0, z0), jnp.arange(A.shape[0] // C))
    return (qhi + qlo) + (phi + plo)


def make_lasso_device(N, n, p=8, lam=1.0, rho=10.0, seed=0):
    """:func:`make_lasso` (``well_conditioned=True``) built in f32 on
    the default device from ``seed``: a host-built operator of many
    GB would spend minutes in transfer. Same KKT construction — unit
    dual y*, column scales capped at the p-th largest |C_jᵀy*|, x* on
    the top-p columns with matching signs, b = A x* + y*."""
    import jax
    import jax.numpy as jnp

    HI = jax.lax.Precision.HIGHEST

    @jax.jit
    def build(key):
        k1, k2, k3 = jax.random.split(key, 3)
        y = jax.random.uniform(k1, (N,), jnp.float32)
        y = y / jnp.sqrt(jnp.vdot(y, y, precision=HI))
        C = jax.random.uniform(k2, (N, n), jnp.float32) * 2.0 - 1.0
        CTy = jnp.abs(jnp.dot(C.T, y, precision=HI))
        pth = jnp.sort(CTy)[-p]
        alpha = jnp.minimum(lam / jnp.maximum(CTy, 1e-30), lam / pth)
        A = C * alpha[None, :]
        sgn = jnp.sign(jnp.dot(A.T, y, precision=HI))
        xs = jnp.where(
            CTy >= pth,
            jax.random.uniform(k3, (n,), jnp.float32) * float(rho / np.sqrt(p))
            * sgn, 0.0)
        b = jnp.dot(A, xs, precision=HI) + y
        r_star = jnp.dot(A, xs, precision=HI) - b
        L = jnp.sum(A * A, axis=1) * N
        return A, b, r_star, xs, L

    A, b, r_star, xs, L = build(jax.random.PRNGKey(seed))
    f_star = (0.5 * float(jnp.vdot(r_star, r_star, precision=HI))
              + lam * float(np.abs(np.asarray(xs, np.float64)).sum()))
    return DeviceLassoProblem(A=A, b=b, r_star=r_star, x_star=xs, L=L,
                              lam=float(lam), f_star=f_star)


class LogisticProblem(NamedTuple):
    X: np.ndarray
    y: np.ndarray
    lam: float
    x_star: np.ndarray
    L: np.ndarray

    def cost(self, x):
        x = np.asarray(x)
        t = -self.y * (self.X @ x)
        return float(
            np.sum(np.logaddexp(0.0, t)) / len(self.y)
            + self.lam * np.sum(np.abs(x))
        )


def make_logistic_l1():
    """The reference's fixed 8-sample, 5-feature problem
    (test_logistic_l1.jl:12-29) with its hardcoded optimum."""
    x_class1 = np.array(
        [
            [5.1, 3.5, 1.4, 0.2, 1.0],
            [4.9, 3.0, 1.4, 0.2, 1.0],
            [4.7, 3.2, 1.3, 0.2, 1.0],
            [4.6, 3.1, 1.5, 0.2, 1.0],
        ]
    )
    x_class2 = np.array(
        [
            [5.7, 3.0, 4.2, 1.2, 1.0],
            [5.7, 2.9, 4.2, 1.3, 1.0],
            [6.2, 2.9, 4.3, 1.3, 1.0],
            [5.1, 2.5, 3.0, 1.1, 1.0],
        ]
    )
    X = np.vstack([x_class1, x_class2])
    y = np.concatenate([np.ones(4), -np.ones(4)])
    x_star = np.array([0.0, 0.924160995722576, -1.1343956493097298, 0.0, 0.0])
    N = len(y)
    L = 0.25 * np.sum(X**2, axis=1)
    return LogisticProblem(X=X, y=y, lam=1.0 / N, x_star=x_star, L=L)


class SharingProblem(NamedTuple):
    d: np.ndarray        # (N, n) quadratic diagonals
    q: np.ndarray        # (N, n) linear terms
    eta: float
    box_lo: float
    box_hi: float
    g_hi: np.ndarray     # upper bound for g = IndBox(-inf, g_hi) on Σ x_i
    sum_star: np.ndarray
    L: np.ndarray


def make_sharing():
    """The reference's sharing problem (test_sharing.jl:11-28).

    Behavioral parity note: the reference computes L_i as
    ``opnorm(Q[i]) + η`` where ``Q[i]`` is a scalar LINEAR index into the
    matrix (almost certainly a typo for Q), yielding L = [|d_1[0]|+η, 0+η,
    0+η] = [31, 30, 30]. We reproduce the values actually used.
    """
    n, N = 2, 3
    eta = N * 10.0
    d = np.array([[1.0, 2.0], [-1.0, 3.0], [0.0, 10.0]])
    q = np.ones((N, n))
    # Q[i] linear-index quirk: Q1[1,1]=1, Q2[2,1]=0, Q3[1,2]=0 (1-based cols)
    L = np.array([abs(d[0, 0]) + eta, 0.0 + eta, 0.0 + eta])
    sum_star = np.array([-5.136781609195401, -0.9333333333333327])
    return SharingProblem(
        d=d, q=q, eta=eta, box_lo=-2.0, box_hi=2.0,
        g_hi=np.ones(n), sum_star=sum_star, L=L,
    )


class PlantedSharingProblem(NamedTuple):
    """Any-scale sharing problem with a CLOSED-FORM exact optimum."""

    d: np.ndarray        # (N, n) quadratic diagonals (all > 0), f64
    q: np.ndarray        # (N, n) linear terms, f64
    lam: float           # g = lam * ||.||_1 on the coupling sum
    x_star: np.ndarray   # (N, n) exact block optima, f64
    u_star: np.ndarray   # (n,) optimal coupling sum (exact zeros off-support)
    v_star: np.ndarray   # (n,) optimal dual (element of lam*d||u*||_1)
    f_star: float        # exact optimal value
    L: np.ndarray        # (N,) block smoothness moduli max_j d_ij

    def cost(self, blocks) -> float:
        """Sharing objective (1/N) Σ f_i(x_i) + λ‖Σ x_i‖₁ at the (N, n)
        block matrix, evaluated in f64."""
        x = np.asarray(blocks, np.float64)
        quad = 0.5 * np.sum(self.d * x * x) + np.sum(self.q * x)
        return quad / self.d.shape[0] + self.lam * np.sum(
            np.abs(x.sum(axis=0)))


def make_sharing_planted(N=4096, n=128, p=None, seed=0):
    """Planted sharing problem at ANY scale (the deep-accuracy analog of
    :func:`make_lasso` for the sharing formulation — the reference's
    only sharing instance is the N=3 hardcoded one above,
    ``test/test_sharing.jl:11-28``, and it gets its tolerance from f64
    for free; this gives an exact f* to measure f32 floors against).

        min (1/N) Σ_i [½⟨x_i, d_i ⊙ x_i⟩ + ⟨q_i, x_i⟩] + λ‖Σ_i x_i‖₁

    KKT closes in one soft-threshold: stationarity forces
    ∇f_i(x_i)/1 = −N v with v ∈ λ∂‖u‖₁, so x_i = −(q_i + N v)/d_i and
    per coordinate j the dual is v_j = clip(v0_j, ±λ) with
    v0_j = −(Σ_i q_ij/d_ij)/(N Σ_i 1/d_ij) — on-support coordinates
    (|v0_j| > λ) get u*_j = N S_j (v0_j − λ sign v0_j) whose sign
    matches v_j automatically, off-support get u*_j = 0 exactly.
    λ is placed between the p-th and (p+1)-th largest |v0| so the
    support size is exactly ``p`` (default n//8). d ∈ [1, 2] keeps every
    block well-conditioned; q carries a shared per-coordinate mean so
    the coupling term is a material fraction of the objective.
    Everything is computed and returned in f64."""
    if p is None:
        p = max(1, n // 8)
    assert 0 < p < n
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 2.0, size=(N, n))
    mu = rng.standard_normal(n)
    q = mu[None, :] + rng.standard_normal((N, n))

    S = np.sum(1.0 / d, axis=0)                   # (n,)
    Q = np.sum(q / d, axis=0)                     # (n,)
    v0 = -Q / (N * S)
    mags = np.sort(np.abs(v0))[::-1]
    lam = float(0.5 * (mags[p - 1] + mags[p]))    # support = top-p of |v0|
    v = np.clip(v0, -lam, lam)
    x_star = -(q + N * v[None, :]) / d
    u_star = N * S * (v0 - v)                     # exact zeros off-support
    f_star = float(
        (0.5 * np.sum(d * x_star * x_star) + np.sum(q * x_star)) / N
        + lam * np.sum(np.abs(u_star))
    )
    return PlantedSharingProblem(
        d=d, q=q, lam=lam, x_star=x_star, u_star=u_star, v_star=v,
        f_star=f_star, L=np.max(d, axis=1),
    )


class SparseLassoProblem(NamedTuple):
    """Planted power-law SPARSE Lasso (rcv1-style): the same operator in
    both sparse layouts, with the exact optimum known by KKT
    construction. Built ENTIRELY on device (``make_sparse_lasso_ell``)
    — at the 1M×65k scale a host-side dense build would be 260 GB."""

    ell: object          # SparseLeastSquaresELL     (pure-ELL layout)
    hybrid: object       # HybridSparseLeastSquares  (hot/cold layout)
    lam: float
    x_star: object       # (n,) device
    f_star: float        # exact optimal cost (½‖y*‖² + λ‖x*‖₁)
    L: object            # (N,) device per-row moduli (× N scaling)


def make_sparse_lasso_ell(N=4096, n=4096, *, hot=256, k_hot=12, k_cold=4,
                          p=32, lam=1.0, rho=10.0, beta=1.1, seed=0):
    """Plant a p-sparse Lasso on a POWER-LAW sparse design, returned in
    both sparse layouts (pure ELL and hot/cold hybrid) over the SAME
    operator.

    Construction mirrors :func:`make_lasso`'s well-conditioned KKT
    recipe, executed with sparse primitives only: each row draws
    ``k_hot`` entries from the hot columns [0, hot) and ``k_cold`` from
    the cold tail [hot, n), both with (j+1)^-beta popularity (hot
    columns are the popular head — rcv1-style doc×term data); a unit
    dual y* fixes the column scales α_j = min(λ/|A_jᵀy*|, cap) with the
    cap at the p-th largest correlation, x* lives on those top-p
    columns with matching signs, and b = A x* + y*. KKT then holds
    exactly: f* = ½ + λ‖x*‖₁ with no reference solver.

    Duplicate draws: hot duplicates within a row are legitimate (they
    merge additively — the dense hot block of the hybrid layout merges
    them, the ELL layout keeps the raw entries; the OPERATOR is
    identical either way and L is computed on the merged vector); cold
    duplicates are zeroed (kept-first) so the cold ‖·‖² is exact.
    """
    import jax
    import jax.numpy as jnp

    hot_pad = max(128, -(-hot // 128) * 128)

    @jax.jit
    def build(key):
        k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
        wj = (jnp.arange(n, dtype=jnp.float32) + 1.0) ** (-beta)
        cdf_h = jnp.cumsum(wj[:hot]); cdf_h = cdf_h / cdf_h[-1]
        cdf_c = jnp.cumsum(wj[hot:]); cdf_c = cdf_c / cdf_c[-1]
        hot_idx = jnp.searchsorted(
            cdf_h, jax.random.uniform(k1, (N, k_hot)), side="right"
        ).astype(jnp.int32)
        cold_idx = (hot + jnp.searchsorted(
            cdf_c, jax.random.uniform(k2, (N, k_cold)), side="right"
        )).astype(jnp.int32)
        # zero duplicate cold entries (kept-first) so Σ val² is exact
        srt = jnp.sort(cold_idx, axis=1)
        dup_sorted = jnp.concatenate(
            [jnp.zeros((N, 1), bool), srt[:, 1:] == srt[:, :-1]], axis=1)
        # map "duplicate" back to the unsorted slots: a slot is a dup if
        # an EARLIER slot carries the same id
        earlier = (cold_idx[:, :, None] == cold_idx[:, None, :])
        tri = jnp.tril(jnp.ones((k_cold, k_cold), bool), -1)[None]
        is_dup = jnp.any(earlier & tri, axis=2)
        del dup_sorted
        hot_val = jax.random.uniform(k3, (N, k_hot), jnp.float32) * 2 - 1
        cold_val = (jax.random.uniform(k4, (N, k_cold), jnp.float32) * 2
                    - 1) * (~is_dup)
        y = jax.random.uniform(k5, (N,), jnp.float32)
        y = y / jnp.sqrt(jnp.vdot(y, y))
        # signed correlations s = Aᵀy via scatter-add (merges duplicates)
        s = jnp.zeros(n, jnp.float32)
        s = s.at[hot_idx.reshape(-1)].add((y[:, None] * hot_val).reshape(-1))
        s = s.at[cold_idx.reshape(-1)].add((y[:, None] * cold_val).reshape(-1))
        c = jnp.abs(s)
        # COLUMN-NORM EQUALIZATION (the sparse analog of make_lasso's
        # well_conditioned cap): the KKT scale α_j = λ/c_j FORCES the
        # support column norms to λ·ν_j/c_j (ν = raw column norm), so
        # pick the support where that forced norm lands on the target
        # t (the median of the forced norms) and CAP every other
        # column's norm at t via α_j = min(λ/c_j, t/ν_j) — KKT still
        # holds (α ≤ λ/c keeps |A_jᵀy*| ≤ λ off-support) and all
        # columns carry ~equal norm, so the design is near-Wishart
        # (κ ≈ (1+√(n/N))²/(1−√(n/N))²) instead of the raw power-law
        # spectrum, on which every uniform-sampling solver stalls
        # (measured: top-of-c support → rel 20 after 400 epochs; this
        # recipe → rel 1e-3 in ~60).
        nu2 = jnp.zeros(n, jnp.float32)
        nu2 = nu2.at[hot_idx.reshape(-1)].add(
            (hot_val * hot_val).reshape(-1))
        nu2 = nu2.at[cold_idx.reshape(-1)].add(
            (cold_val * cold_val).reshape(-1))
        nu = jnp.sqrt(nu2)
        r = lam * nu / jnp.maximum(c, 1e-30)      # forced support norm
        r = jnp.where(nu > 0, r, jnp.inf)
        t = jnp.nanquantile(jnp.where(jnp.isfinite(r), r, jnp.nan), 0.5,
                            method="nearest")
        # support: the p columns whose forced norm is closest to t
        # from above (≥ t so no off-support cap conflicts with them)
        key_rank = jnp.where(r >= t, r - t, jnp.inf)
        kth = jnp.sort(key_rank)[p - 1]
        supp = key_rank <= kth
        # STRICT dual slack off the support: a continuous r-density
        # near t would otherwise leave thousands of columns with
        # |A_jᵀy*| within ε of λ (near-active — support identification
        # crawls; measured rel 486 after 576 epochs at 131k×16k). The
        # 0.95/0.8 factors push every off-support correlation to
        # ≤ 0.95λ and every off-support norm to ≤ 0.8t.
        alpha = jnp.where(
            supp,
            lam / jnp.maximum(c, 1e-30),
            jnp.minimum(0.95 * lam / jnp.maximum(c, 1e-30),
                        0.8 * t / jnp.maximum(nu, 1e-30)),
        )
        hot_val = hot_val * alpha[hot_idx]
        cold_val = cold_val * alpha[cold_idx]
        xs = jnp.where(
            supp,
            jax.random.uniform(k6, (n,), jnp.float32)
            * jnp.asarray(rho / np.sqrt(p), jnp.float32) * jnp.sign(s),
            0.0)
        m = (jnp.sum(hot_val * jnp.take(xs, hot_idx, axis=0), axis=1)
             + jnp.sum(cold_val * jnp.take(xs, cold_idx, axis=0), axis=1))
        b = m + y
        # merged hot block (the hybrid layout's dense part)
        A_hot = jnp.zeros((N, hot_pad), jnp.float32)
        rows_ = jnp.broadcast_to(jnp.arange(N)[:, None], hot_idx.shape)
        A_hot = A_hot.at[rows_.reshape(-1), hot_idx.reshape(-1)].add(
            hot_val.reshape(-1))
        L = (jnp.sum(A_hot * A_hot, axis=1)
             + jnp.sum(cold_val * cold_val, axis=1)) * N
        return (hot_idx, hot_val, cold_idx, cold_val, b, y, xs, A_hot, L)

    import jax.random as jrandom

    (hot_idx, hot_val, cold_idx, cold_val, b, y, xs, A_hot, L) = build(
        jrandom.PRNGKey(seed))

    from ciao_tpu.oracles import (
        HybridSparseLeastSquares, SparseLeastSquaresELL,
    )
    import jax.numpy as jnp

    scale = jnp.asarray(float(N), jnp.float32)
    ell = SparseLeastSquaresELL(
        idx=jnp.concatenate([hot_idx, cold_idx], axis=1),
        val=jnp.concatenate([hot_val, cold_val], axis=1),
        b=b, scale=scale, n_dim=n,
    )
    hybrid = HybridSparseLeastSquares(
        A_hot=A_hot, hot_cols=jnp.arange(hot_pad, dtype=jnp.int32),
        idx=cold_idx, val=cold_val, b=b, scale=scale, n_dim=n,
    )
    xs_np = np.asarray(xs, np.float64)
    y_np = np.asarray(y, np.float64)
    f_star = 0.5 * float(y_np @ y_np) + lam * float(np.abs(xs_np).sum())
    return SparseLassoProblem(ell=ell, hybrid=hybrid, lam=float(lam),
                              x_star=xs, f_star=f_star, L=L)


class PlantedFusedLassoProblem(NamedTuple):
    """Any-scale fused lasso (1-D analysis sparsity) with a CLOSED-FORM
    exact optimum — the deep-accuracy instance for the primal-dual
    class (Condat-Vũ / Chambolle-Pock), which the prox-of-g-only
    reference cannot express at all."""

    A: np.ndarray        # (N, n) design, f64
    b: np.ndarray        # (N,)
    lam: float           # h = lam * ||.||_1 on Dx (D = FirstDifference)
    x_star: np.ndarray   # (n,) exact optimum (piecewise constant)
    v_star: np.ndarray   # (n-1,) optimal dual, |v| <= lam, interior off-jump
    f_star: float        # exact optimal value
    L: np.ndarray        # (N,) per-row moduli x N (the library convention)

    def cost(self, x) -> float:
        """½‖Ax − b‖² + λ‖Dx‖₁ in f64 (the un-normalized quadratic —
        same convention as :class:`LassoProblem`)."""
        x = np.asarray(x, np.float64)
        r = self.A @ x - self.b
        return float(0.5 * np.dot(r, r) + self.lam * np.sum(np.abs(np.diff(x))))


def make_fused_lasso_planted(N=4096, n=256, jumps=None, lam=1.0, rho=5.0,
                             seed=0):
    """Plant the EXACT optimum of  ½‖Ax−b‖² + λ‖Dx‖₁  ((Dx)_i =
    x_{i+1}−x_i) at ANY (N, n) scale via a RANK-ONE dual correction.

    Stationarity needs  Aᵀ(Ax*−b) + Dᵀv = 0  with v ∈ λ∂‖Dx*‖₁. Draw a
    unit residual y*, set b = Ax* + y* so the condition becomes
    Aᵀy* = Dᵀv, and ENFORCE it exactly with a rank-1 update of a raw
    unit-uniform design C:

        A = C + y*·cᵀ,   c = Dᵀv − Cᵀy*       (‖y*‖ = 1)

    — unlike the column-rescaling trick of :func:`make_lasso` (which
    here would divide by near-zero entries of Dᵀv and destroy the
    conditioning), the rank-1 correction perturbs each column by O(1)
    against the O(√N) column norms, so κ(AᵀA) stays that of a random
    design. x* is piecewise constant with ``jumps`` sign-alternating
    levels; v takes λ·sign at the jumps and strictly interior values
    (≤ 0.6λ) on the flat runs, so the optimum is unique and the jump
    set is stable. Everything is computed and returned in f64;
    f* = ½ + λ‖Dx*‖₁ exactly (‖y*‖ = 1)."""
    if jumps is None:
        jumps = max(2, n // 32)
    assert 2 <= jumps + 1 <= n
    rng = np.random.default_rng(seed)

    # piecewise-constant x*: jumps+1 sign-alternating levels
    bounds = np.sort(rng.choice(np.arange(1, n), size=jumps, replace=False))
    levels = rho * (0.5 + rng.random(jumps + 1)) * \
        (-1.0) ** np.arange(jumps + 1)
    x_star = np.repeat(levels, np.diff(np.concatenate(([0], bounds, [n]))))

    d = np.diff(x_star)
    v = rng.uniform(-0.6, 0.6, n - 1) * lam      # interior on flat runs
    jump_mask = d != 0
    v[jump_mask] = lam * np.sign(d[jump_mask])

    Dt_v = np.zeros(n)
    Dt_v[:-1] -= v
    Dt_v[1:] += v

    y = rng.standard_normal(N)
    y /= np.linalg.norm(y)
    C = rng.uniform(-1.0, 1.0, (N, n))
    A = C + np.outer(y, Dt_v - C.T @ y)          # Aᵀy* = Dᵀv exactly
    b = A @ x_star + y

    f_star = 0.5 + lam * float(np.sum(np.abs(d)))
    L = np.sum(A * A, axis=1) * N                # row moduli x N
    return PlantedFusedLassoProblem(
        A=A, b=b, lam=float(lam), x_star=x_star, v_star=v,
        f_star=f_star, L=L,
    )


class PlantedThreeTermProblem(NamedTuple):
    """Any-scale THREE-TERM fused lasso with a closed-form optimum:
    ½‖Ax−b‖² + λ₁‖x‖₁ + λ₂‖Dx‖₁ (sparse AND piecewise-constant)."""

    A: np.ndarray
    b: np.ndarray
    lam1: float          # ℓ1 weight on x
    lam2: float          # ℓ1 weight on Dx
    x_star: np.ndarray   # piecewise constant WITH exact-zero segments
    u_star: np.ndarray   # (n,) ℓ1 dual, |u| ≤ λ₁, interior on zeros
    v_star: np.ndarray   # (n-1,) TV dual, |v| ≤ λ₂, interior off-jump
    f_star: float
    L: np.ndarray

    def cost(self, x) -> float:
        x = np.asarray(x, np.float64)
        r = self.A @ x - self.b
        return float(0.5 * np.dot(r, r) + self.lam1 * np.sum(np.abs(x))
                     + self.lam2 * np.sum(np.abs(np.diff(x))))


def make_three_term_planted(N=4096, n=256, jumps=None, lam1=0.5, lam2=1.0,
                            rho=5.0, seed=0):
    """Plant the exact optimum of the THREE-TERM objective by the same
    rank-1 dual correction as :func:`make_fused_lasso_planted`, with
    TWO multipliers: stationarity needs ``Aᵀy* = u + Dᵀv`` where
    u ∈ λ₁∂‖x*‖₁ (λ₁·sign on the support, interior ≤ 0.6λ₁ on the
    zero segments) and v ∈ λ₂∂‖Dx*‖₁ (λ₂·sign at jumps, interior
    ≤ 0.6λ₂ on flat runs). Every third segment is pinned EXACTLY zero
    so both structures are non-trivial. Everything f64;
    f* = ½ + λ₁‖x*‖₁ + λ₂‖Dx*‖₁ exactly."""
    if jumps is None:
        jumps = max(3, n // 32)
    assert 3 <= jumps + 1 <= n
    rng = np.random.default_rng(seed)

    bounds = np.sort(rng.choice(np.arange(1, n), size=jumps, replace=False))
    widths = np.diff(np.concatenate(([0], bounds, [n])))
    levels = rho * (0.5 + rng.random(jumps + 1)) * \
        (-1.0) ** np.arange(jumps + 1)
    levels[::3] = 0.0                       # exact-zero segments
    # a zero level between same-sign neighbors still jumps; but two
    # ADJACENT zeros would merge — the ::3 pattern never does that
    x_star = np.repeat(levels, widths)

    d = np.diff(x_star)
    v = rng.uniform(-0.6, 0.6, n - 1) * lam2
    jm = d != 0
    v[jm] = lam2 * np.sign(d[jm])
    u = np.where(x_star != 0, lam1 * np.sign(x_star),
                 rng.uniform(-0.6, 0.6, n) * lam1)

    Dt_v = np.zeros(n)
    Dt_v[:-1] -= v
    Dt_v[1:] += v

    y = rng.standard_normal(N)
    y /= np.linalg.norm(y)
    C = rng.uniform(-1.0, 1.0, (N, n))
    A = C + np.outer(y, u + Dt_v - C.T @ y)   # Aᵀy* = u + Dᵀv exactly
    b = A @ x_star + y

    f_star = (0.5 + lam1 * float(np.sum(np.abs(x_star)))
              + lam2 * float(np.sum(np.abs(d))))
    L = np.sum(A * A, axis=1) * N
    return PlantedThreeTermProblem(
        A=A, b=b, lam1=float(lam1), lam2=float(lam2), x_star=x_star,
        u_star=u, v_star=v, f_star=f_star, L=L,
    )

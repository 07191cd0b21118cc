"""Condat-Vũ / Chambolle-Pock primal-dual splitting (beyond the
reference — the h(Kx) capability the prox-of-g-only reference line
cannot express, `/root/reference/src/algorithms/Finito/
Finito_basic.jl:84`). Pins: the Moreau-identity dual prox against
closed-form conjugate proxes, the linear maps' adjoint identities and
operator-norm bounds, Chambolle-Pock (f = 0) against a closed-form
optimum, 1-D TV denoising with an exact optimality certificate, a
PLANTED fused-lasso optimum, the iterator invariants, and the DP
trajectory equality."""

import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu import DenseMap, FirstDifference, IdentityMap
from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import IndBox, NormL1, SqrDistPoint, Zero
from ciao_tpu.solvers.primal_dual import prox_conjugate

# ---------------------------------------------------------------------------
# unit: prox of the conjugate (Moreau identity)
# ---------------------------------------------------------------------------


def test_prox_conjugate_l1_is_linf_ball_projection():
    """(λ‖·‖₁)* = ind of the ℓ∞ ball of radius λ, so prox_{σh*} is the
    σ-independent clip onto [−λ, λ]."""
    u = jnp.asarray(np.linspace(-3.0, 3.0, 41))
    lam = 0.8
    h = NormL1(lam=jnp.asarray(lam))
    for sigma in (0.1, 1.0, 7.3):
        out = prox_conjugate(h, u, jnp.asarray(sigma))
        np.testing.assert_allclose(
            np.asarray(out), np.clip(np.asarray(u), -lam, lam),
            rtol=0, atol=1e-12,
        )


def test_prox_conjugate_quadratic_closed_form():
    """h(x) = (ρ/2)‖x−b‖² has h*(y) = ⟨y,b⟩ + ‖y‖²/(2ρ), whose σ-prox
    is the affine map (u − σb)/(1 + σ/ρ)."""
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(16))
    b = jnp.asarray(rng.standard_normal(16))
    rho, sigma = 2.3, 0.6
    h = SqrDistPoint(b=b, rho=jnp.asarray(rho))
    out = prox_conjugate(h, u, jnp.asarray(sigma))
    expect = (np.asarray(u) - sigma * np.asarray(b)) / (1.0 + sigma / rho)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-12, atol=0)


def test_prox_conjugate_box_support_function():
    """(ind_[lo,hi])* is the support function; its σ-prox is
    u − σ·clip(u/σ, lo, hi) — verified against a 1-D brute-force
    minimization of σh*(y) + ½(y−u)²."""
    lo, hi, sigma = -0.5, 2.0, 1.7
    h = IndBox(lo=lo, hi=hi)
    grid = np.linspace(-6, 6, 120001)  # y grid
    # h*(y) = max_{x in [lo,hi]} xy  (support function of the box)
    hstar = np.maximum(grid * lo, grid * hi)
    for uv in (-3.0, -0.2, 0.0, 1.4, 4.2):
        out = float(prox_conjugate(h, jnp.asarray([uv]), jnp.asarray(sigma))[0])
        brute = grid[np.argmin(sigma * hstar + 0.5 * (grid - uv) ** 2)]
        assert abs(out - brute) < 2e-4
        assert abs(out - (uv - sigma * np.clip(uv / sigma, lo, hi))) < 1e-12


# ---------------------------------------------------------------------------
# unit: linear maps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_linmap_adjoint_identity(dtype):
    """⟨Kx, y⟩ = ⟨x, Kᵀy⟩ (conjugate-transpose for complex) for every
    concrete map — a sign error here breaks every primal-dual run."""
    rng = np.random.default_rng(1)

    def rand(m):
        v = rng.standard_normal(m)
        if np.issubdtype(dtype, np.complexfloating):
            v = v + 1j * rng.standard_normal(m)
        return jnp.asarray(v.astype(dtype))

    n = 13
    M = rand(7 * n).reshape(7, n)
    for K in (IdentityMap(), FirstDifference(), DenseMap(M=M)):
        m = K.out_dim(n)
        x, y = rand(n), rand(m)
        lhs = complex(jnp.vdot(y, K.matvec(x)))
        rhs = complex(jnp.vdot(K.rmatvec(y), x))
        assert abs(lhs - rhs) < 1e-10 * (1 + abs(lhs))


def test_linmap_opnorm_bounds():
    """opnorm_bound must UPPER-bound the true spectral norm (an
    underestimate breaks the stepsize condition)."""
    rng = np.random.default_rng(2)
    n = 24
    # FirstDifference: materialize D and compare
    D = np.zeros((n - 1, n))
    for i in range(n - 1):
        D[i, i], D[i, i + 1] = -1.0, 1.0
    fd = FirstDifference()
    true_fd = np.linalg.norm(D, 2)
    assert true_fd <= fd.opnorm_bound(n) <= 2.0 + 1e-12
    x = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(np.asarray(fd.matvec(x)), D @ np.asarray(x),
                               rtol=1e-12, atol=1e-14)
    M = rng.standard_normal((10, n))
    dm = DenseMap(M=jnp.asarray(M))
    assert abs(dm.opnorm_bound(n) - np.linalg.norm(M, 2)) < 1e-8


# ---------------------------------------------------------------------------
# acceptance: planted / closed-form optima
# ---------------------------------------------------------------------------


def test_chambolle_pock_closed_form():
    """f = 0, K = I: min (1/2)‖x−b‖² + λ‖x‖₁ — optimum soft(b, λ).
    This pins the whole primal-dual recursion on a problem whose only
    nontrivial piece is the dual (conjugate-prox) update."""
    b = jnp.asarray(np.linspace(-2.0, 2.0, 16))
    lam = 0.7
    g = SqrDistPoint(b=b, rho=jnp.asarray(1.0))
    h = NormL1(lam=jnp.asarray(lam))
    x, it = ciao_tpu.ChambollePock(maxit=2000)(
        jnp.zeros(16, b.dtype), g=g, h=h, N=1
    )
    x_star = np.sign(np.asarray(b)) * np.maximum(np.abs(np.asarray(b)) - lam, 0)
    np.testing.assert_allclose(np.asarray(x), x_star, rtol=0, atol=1e-8)
    assert it == 2000


def _tv_certificate(x, b, lam):
    """Exact optimality certificate for min ½‖x−b‖² + λ‖Dx‖₁: a dual
    z with x − b + λDᵀz = 0, ‖z‖∞ ≤ 1, z = sign(Dx) on active jumps."""
    n = x.shape[0]
    D = np.zeros((n - 1, n))
    for i in range(n - 1):
        D[i, i], D[i, i + 1] = -1.0, 1.0
    z, res, *_ = np.linalg.lstsq(D.T, (b - x) / lam, rcond=None)
    assert np.linalg.norm(D.T @ z - (b - x) / lam, np.inf) < 1e-6
    assert np.max(np.abs(z)) <= 1.0 + 1e-6
    d = D @ x
    active = np.abs(d) > 1e-6
    np.testing.assert_allclose(z[active], np.sign(d[active]),
                               rtol=0, atol=1e-6)


def test_tv_denoise_certificate_and_smooth_equivalence():
    """1-D TV denoising min ½‖x−b‖² + λ‖Dx‖₁ two ways — Chambolle-Pock
    (quadratic as prox) and Condat-Vũ (quadratic as the smooth
    finite-sum) — both must satisfy the EXACT subdifferential
    certificate and agree with each other."""
    rng = np.random.default_rng(3)
    n = 32
    truth = np.repeat([0.0, 1.5, -0.5, 2.0], n // 4)
    b_np = truth + 0.3 * rng.standard_normal(n)
    b = jnp.asarray(b_np)
    lam = 0.4
    K = FirstDifference()
    h = NormL1(lam=jnp.asarray(lam))

    x_cp, _ = ciao_tpu.ChambollePock(maxit=20000)(
        jnp.zeros(n, b.dtype), g=SqrDistPoint(b=b, rho=jnp.asarray(1.0)),
        h=h, K=K, N=1,
    )
    # same objective with the quadratic as the SMOOTH term:
    # (1/N)Σ (N/2)(x_i − b_i)² = ½‖x−b‖², rows of the identity
    F = LeastSquaresRows(A=jnp.eye(n, dtype=b.dtype), b=b,
                         scale=jnp.asarray(float(n), b.dtype))
    L = np.full(n, float(n))
    x_cv, _ = ciao_tpu.CondatVu(maxit=20000)(
        jnp.zeros(n, b.dtype), F=F, h=h, K=K, L=L, N=n,
    )
    _tv_certificate(np.asarray(x_cp), b_np, lam)
    _tv_certificate(np.asarray(x_cv), b_np, lam)
    np.testing.assert_allclose(np.asarray(x_cv), np.asarray(x_cp),
                               rtol=0, atol=5e-6)
    # TV produced exact flat runs (piecewise constant, not dense noise)
    assert np.sum(np.abs(np.diff(np.asarray(x_cp))) > 1e-4) < n // 2


def _planted_fused_lasso(n=40, lam1=0.3, lam2=0.5, seed=4):
    """Plant the EXACT optimum of ½‖x−b‖² + λ₁‖x‖₁ + λ₂‖Dx‖₁ by
    choosing interior subgradients and solving the stationarity
    condition for b (SURVEY.md §4's planted-optimum recipe applied to
    the three-term objective)."""
    rng = np.random.default_rng(seed)
    x_star = np.repeat([0.0, 1.5, 0.0, -2.0, 0.75], n // 5)
    # z1 ∈ ∂‖x*‖₁ — strictly interior on the zeros
    z1 = np.sign(x_star)
    z1[x_star == 0] = rng.uniform(-0.6, 0.6, np.sum(x_star == 0))
    d = np.diff(x_star)
    # z2 ∈ ∂‖Dx*‖₁ — strictly interior on the flat runs
    z2 = np.sign(d)
    z2[d == 0] = rng.uniform(-0.6, 0.6, np.sum(d == 0))
    Dt_z2 = np.zeros(n)
    Dt_z2[:-1] -= z2
    Dt_z2[1:] += z2
    b = x_star + lam1 * z1 + lam2 * Dt_z2  # 0 ∈ ∂obj(x*) exactly
    return x_star, b


def test_fused_lasso_planted_optimum():
    """Condat-Vũ on the full three-term form: smooth quadratic +
    g = λ₁‖·‖₁ (prox'd directly) + h = λ₂‖·‖₁ of Dx (dualized)."""
    n, lam1, lam2 = 40, 0.3, 0.5
    x_star, b_np = _planted_fused_lasso(n, lam1, lam2)
    b = jnp.asarray(b_np)
    F = LeastSquaresRows(A=jnp.eye(n, dtype=b.dtype), b=b,
                         scale=jnp.asarray(float(n), b.dtype))
    x, _ = ciao_tpu.CondatVu(maxit=30000)(
        jnp.zeros(n, b.dtype), F=F, g=NormL1(lam=jnp.asarray(lam1)),
        h=NormL1(lam=jnp.asarray(lam2)), K=FirstDifference(),
        L=np.full(n, float(n)), N=n,
    )
    assert np.max(np.abs(np.asarray(x) - x_star)) < 1e-5


def test_condat_vu_k_identity_matches_davis_yin():
    """With K = I the three-term problem is exactly Davis-Yin's; the
    two different splittings must find the same minimizer."""
    from ciao_tpu.utils.problems import make_lasso

    N, n = 64, 8
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(float(N)))
    g = NormL1(lam=jnp.asarray(prob.lam))
    h = IndBox(lo=-0.4, hi=0.4)
    z0 = jnp.zeros(n, prob.A.dtype)
    x_cv, _ = ciao_tpu.CondatVu(maxit=20000)(z0, F=F, g=g, h=h, L=prob.L, N=N)
    x_dys, _ = ciao_tpu.DavisYin(maxit=20000)(z0, F=F, g=g, h=h,
                                              L=prob.L, N=N)
    np.testing.assert_allclose(np.asarray(x_cv), np.asarray(x_dys),
                               rtol=0, atol=2e-7)
    assert np.max(np.abs(np.asarray(x_cv))) <= 0.4 + 1e-9


def test_chambolle_pock_complex_dtype():
    """Complex iterates through the primal-dual recursion (the
    library-wide c64/c128 capability, reference test_lasso.jl:3): the
    soft threshold of the conjugate-prox pair acts on |·| with the
    phase preserved, so min ½‖x−b‖² + λ‖x‖₁ over ℂ has the closed-form
    complex soft-threshold optimum."""
    rng = np.random.default_rng(9)
    b_np = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    b = jnp.asarray(b_np, jnp.complex128)
    lam = 0.7
    g = SqrDistPoint(b=b, rho=jnp.asarray(1.0))
    h = NormL1(lam=jnp.asarray(lam))
    x, _ = ciao_tpu.ChambollePock(maxit=3000)(
        jnp.zeros(16, b.dtype), g=g, h=h, N=1
    )
    mag = np.maximum(np.abs(b_np) - lam, 0.0)
    x_star = mag * b_np / np.maximum(np.abs(b_np), 1e-300)
    assert np.asarray(x).dtype == np.complex128  # eltype preserved
    np.testing.assert_allclose(np.asarray(x), x_star, rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# iterator invariants + validation
# ---------------------------------------------------------------------------


def test_cv_iterator_invariants():
    from ciao_tpu.solvers.base import take

    n = 16
    b = jnp.asarray(np.linspace(-1.0, 1.0, n))
    F = LeastSquaresRows(A=jnp.eye(n, dtype=b.dtype), b=b,
                         scale=jnp.asarray(float(n), b.dtype))
    h = NormL1(lam=jnp.asarray(0.2))
    L = np.full(n, float(n))
    solver = ciao_tpu.CondatVu(maxit=5)
    it = solver.iterator(jnp.zeros(n, b.dtype), F=F, h=h,
                         K=FirstDifference(), L=L, N=n)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(np.asarray(states[0].solution),
                                  np.zeros(n))
    x_batch, _ = solver(jnp.zeros(n, b.dtype), F=F, h=h,
                        K=FirstDifference(), L=L, N=n)
    np.testing.assert_array_equal(np.asarray(states[-1].solution),
                                  np.asarray(x_batch))
    with pytest.raises(ValueError, match="smoothness"):
        ciao_tpu.CondatVu(maxit=2)(jnp.zeros(n, b.dtype), F=F, h=h, N=n)


def test_cv_stepsize_condition_warning():
    """User-supplied stepsizes violating τ(L/2 + σ‖K‖²) ≤ 1 warn."""
    n = 8
    b = jnp.zeros(n)
    F = LeastSquaresRows(A=jnp.eye(n), b=b, scale=jnp.asarray(float(n)))
    with pytest.warns(UserWarning, match="convergence condition"):
        ciao_tpu.CondatVu(tau=5.0, sigma=5.0, maxit=2)(
            jnp.zeros(n), F=F, h=NormL1(lam=jnp.asarray(0.1)),
            K=FirstDifference(), L=np.full(n, float(n)), N=n,
        )


def test_dp_condat_vu_matches_single_chip():
    """DPCondatVu on the 8-device mesh: deterministic method, so the
    sharded trajectory must equal single-chip to reduction-order
    tolerance — on the full three-term fused lasso."""
    from ciao_tpu.parallel import DPCondatVu, make_mesh, shard_finite_sum
    from ciao_tpu.utils.problems import make_lasso

    N, n = 64, 8
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(float(N)))
    g = NormL1(lam=jnp.asarray(prob.lam))
    h = NormL1(lam=jnp.asarray(0.05))
    K = FirstDifference()
    z0 = jnp.zeros(n, prob.A.dtype)
    mesh = make_mesh()
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPCondatVu(mesh=mesh, maxit=300)(z0, F=Fd, g=g, h=h, K=K,
                                               L=prob.L, N=N)
    x_sc, _ = ciao_tpu.CondatVu(maxit=300)(z0, F=F, g=g, h=h, K=K,
                                           L=prob.L, N=N)
    np.testing.assert_allclose(np.asarray(x_dp), np.asarray(x_sc),
                               rtol=1e-9, atol=1e-12)


def test_dp_chambolle_pock_closed_form():
    """DPChambollePock (f = 0 over the mesh) still reaches the
    closed-form soft-threshold optimum."""
    from ciao_tpu.parallel import DPChambollePock, make_mesh

    n = 16
    b = jnp.asarray(np.linspace(-2.0, 2.0, n))
    lam = 0.7
    x, _ = DPChambollePock(mesh=make_mesh(), maxit=2000)(
        jnp.zeros(n, b.dtype), g=SqrDistPoint(b=b, rho=jnp.asarray(1.0)),
        h=NormL1(lam=jnp.asarray(lam)), N=8,
    )
    x_star = np.sign(np.asarray(b)) * np.maximum(np.abs(np.asarray(b)) - lam, 0)
    np.testing.assert_allclose(np.asarray(x), x_star, rtol=0, atol=1e-8)


def test_cv_checkpoint_resume_continues_exactly(tmp_path):
    """The primal-dual state (primal x + dual y) is an ordinary pytree:
    stopping, checkpointing and resuming must reproduce the
    straight-through trajectory exactly (deterministic method)."""
    from ciao_tpu import checkpoint
    from ciao_tpu.solvers.base import loop, take
    from ciao_tpu.utils.problems import make_lasso

    prob = make_lasso(N=16, n=8, p=3, seed=0)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(16.0))
    h = NormL1(lam=jnp.asarray(0.05))
    K = FirstDifference()
    kwargs = dict(F=F, g=NormL1(lam=jnp.asarray(prob.lam)), h=h, K=K,
                  L=prob.L, N=16)
    solver = ciao_tpu.CondatVu(maxit=100)
    st_full = loop(take(iter(solver.iterator(jnp.zeros(8), **kwargs)), 40))
    st_mid = loop(take(iter(solver.iterator(jnp.zeros(8), **kwargs)), 20))
    checkpoint.save(tmp_path / "mid.npz", st_mid)
    restored = checkpoint.load(tmp_path / "mid.npz")
    it2 = solver.iterator(jnp.zeros(8), **kwargs)
    resumed = loop(take(checkpoint.resume_iterator(it2, restored), 21))
    np.testing.assert_allclose(np.asarray(resumed.x), np.asarray(st_full.x),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(resumed.y), np.asarray(st_full.y),
                               rtol=1e-12, atol=1e-14)


def test_cv_and_dys_observer_three_term_objective():
    """monitor.observer must serve the splitting families: the h=/K=
    extension logs the FULL three-term objective (f + g + h(Kx)) and
    the residual path survives states without a ``z`` field (PDState
    carries x/y; the round-3 fix — it crashed before)."""
    from ciao_tpu import monitor
    from ciao_tpu.utils.problems import make_lasso

    prob = make_lasso(N=16, n=8, p=3, seed=0)
    F = LeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                         scale=jnp.asarray(16.0))
    g = NormL1(lam=jnp.asarray(prob.lam))
    h = NormL1(lam=jnp.asarray(0.05))
    K = FirstDifference()

    tr = monitor.Trace()
    x, _ = ciao_tpu.CondatVu(maxit=200, freq=50)(
        jnp.zeros(8), F=F, g=g, h=h, K=K, L=prob.L, N=16,
        observe=monitor.observer(F, g, tr, h=h, K=K),
    )
    objs = [r["obj"] for r in tr.records if "obj" in r]
    assert len(objs) >= 3 and all(np.isfinite(objs))
    # the log matches an external three-term computation at the result
    xv = np.asarray(x, np.float64)
    # f = (1/N) Σ (N/2) r_i² = ½‖Ax−b‖²
    expect = (0.5 * np.sum((np.asarray(prob.A, np.float64) @ xv
                            - np.asarray(prob.b, np.float64)) ** 2)
              + prob.lam * np.abs(xv).sum()
              + 0.05 * np.abs(np.diff(xv)).sum())
    np.testing.assert_allclose(objs[-1], expect, rtol=1e-6)
    assert objs[-1] < objs[0]
    assert any("residual" in r for r in tr.records)

    # Davis-Yin: h applied to x directly (K omitted)
    tr2 = monitor.Trace()
    ciao_tpu.DavisYin(maxit=200, freq=50)(
        jnp.zeros(8), F=F, g=g, h=IndBox(lo=-1.0, hi=1.0), L=prob.L, N=16,
        observe=monitor.observer(F, g, tr2, h=IndBox(lo=-1.0, hi=1.0)),
    )
    objs2 = [r["obj"] for r in tr2.records if "obj" in r]
    assert len(objs2) >= 3 and np.isfinite(objs2[-1])


def test_tp_condat_vu_matches_single_chip():
    """TPCondatVu (round 4): the halo-exchange stencil K over the
    (4, 2) ("data","model") mesh — one scalar ppermute per K apply —
    must reproduce the single-chip Condat-Vũ trajectory to reduction
    order on a fused-lasso problem (K = FirstDifference)."""
    import ciao_tpu
    from ciao_tpu.parallel import (
        TPCondatVu, make_mesh_2d, shard_finite_sum_2d,
    )

    rng = np.random.default_rng(3)
    Np, npx = 64, 16
    A = jnp.asarray(rng.standard_normal((Np, npx)))
    b = jnp.asarray(rng.standard_normal(Np))
    F = LeastSquaresRows(A=A, b=b, scale=jnp.asarray(float(Np)))
    L = np.asarray(jnp.sum(A * A, axis=1) * Np)
    g = NormL1(lam=jnp.asarray(0.05))
    h = NormL1(lam=jnp.asarray(0.1))
    K = FirstDifference()
    x0 = jnp.zeros(npx)
    mesh = make_mesh_2d(4, 2)
    Fd = shard_finite_sum_2d(F, mesh)
    x_tp, _ = TPCondatVu(mesh=mesh, maxit=300)(
        x0, F=Fd, g=g, h=h, K=K, L=L, N=Np)
    x_sc, _ = ciao_tpu.CondatVu(maxit=300)(
        x0, F=F, g=g, h=h, K=K, L=L, N=Np)
    np.testing.assert_allclose(np.asarray(x_tp), np.asarray(x_sc),
                               rtol=1e-9, atol=1e-12)

    # f = 0: TP Chambolle-Pock ≡ single-chip Chambolle-Pock
    from ciao_tpu.parallel import TPChambollePock

    x_tp0, _ = TPChambollePock(mesh=mesh, maxit=300)(
        x0, g=g, h=h, K=K, N=Np)
    x_sc0, _ = ciao_tpu.ChambollePock(maxit=300)(
        x0, g=g, h=h, K=K, N=Np)
    np.testing.assert_allclose(np.asarray(x_tp0), np.asarray(x_sc0),
                               rtol=1e-9, atol=1e-12)

    # identity-K case shards too
    x_tpi, _ = TPCondatVu(mesh=mesh, maxit=200)(
        x0, F=Fd, g=g, h=h, L=L, N=Np)
    x_sci, _ = ciao_tpu.CondatVu(maxit=200)(
        x0, F=F, g=g, h=h, L=L, N=Np)
    np.testing.assert_allclose(np.asarray(x_tpi), np.asarray(x_sci),
                               rtol=1e-9, atol=1e-12)

    # guards: dense K and non-separable g are DP-only / rejected
    import pytest as _pytest

    from ciao_tpu.ops.linmap import DenseMap
    from ciao_tpu.prox import NormNuclear

    with _pytest.raises(ValueError, match="DenseMap"):
        TPCondatVu(mesh=mesh, maxit=2)(
            x0, F=Fd, g=g, h=h,
            K=DenseMap(M=jnp.eye(npx)), L=L, N=Np)
    with _pytest.raises(ValueError, match="separable"):
        TPCondatVu(mesh=mesh, maxit=2)(
            x0, F=Fd, g=NormNuclear(lam=jnp.asarray(0.1)), h=h, K=K,
            L=L, N=Np)


# ---------------------------------------------------------------------------
# 2-D total variation (FirstDifference2D, round 5)
# ---------------------------------------------------------------------------

def _dense_tv2d(H, W):
    """Explicit dense [D_h; D_v] for cross-checking the stencil map."""
    n = H * W
    rows = []
    for i in range(H):
        for j in range(W - 1):
            r = np.zeros(n)
            r[i * W + j] = -1.0
            r[i * W + j + 1] = 1.0
            rows.append(r)
    for i in range(H - 1):
        for j in range(W):
            r = np.zeros(n)
            r[i * W + j] = -1.0
            r[(i + 1) * W + j] = 1.0
            rows.append(r)
    return np.stack(rows)


def test_first_difference_2d_matches_dense():
    """matvec/rmatvec/out_dim of the stencil map equal the explicit
    dense [D_h; D_v]; the √8 bound dominates the exact spectral norm."""
    from ciao_tpu import FirstDifference2D

    H, W = 6, 5
    K = FirstDifference2D(H=H, W=W)
    M = _dense_tv2d(H, W)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(H * W))
    y = jnp.asarray(rng.standard_normal(M.shape[0]))
    np.testing.assert_allclose(np.asarray(K.matvec(x)), M @ np.asarray(x),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(K.rmatvec(y)), M.T @ np.asarray(y),
                               rtol=0, atol=1e-12)
    assert K.out_dim(H * W) == M.shape[0]
    # adjoint identity and the operator-norm bound
    assert abs(float(jnp.vdot(K.matvec(x), y))
               - float(jnp.vdot(x, K.rmatvec(y)))) < 1e-10
    assert np.linalg.norm(M, 2) <= K.opnorm_bound(H * W)


def test_tv2d_denoise_stencil_equals_dense_trajectory():
    """Chambolle-Pock on 2-D TV denoising: the stencil map and the
    SAME operator as a DenseMap must produce identical trajectories
    (same stepsizes forced — DenseMap's exact ‖K‖ would differ from
    the √8 bound otherwise), and the solution must be blocky."""
    from ciao_tpu import DenseMap, FirstDifference2D
    from ciao_tpu.prox import SqrDistPoint

    H, W = 8, 8
    n = H * W
    rng = np.random.default_rng(1)
    truth = np.zeros((H, W))
    truth[:4, :] = 1.5
    truth[4:, 4:] = -1.0
    b_np = (truth + 0.25 * rng.standard_normal((H, W))).reshape(-1)
    b = jnp.asarray(b_np)
    lam = 0.4
    g = SqrDistPoint(b=b, rho=jnp.asarray(1.0))
    h = NormL1(lam=jnp.asarray(lam))
    tau = sigma = 1.0 / np.sqrt(8.0)
    x_st, _ = ciao_tpu.ChambollePock(maxit=6000, tau=tau, sigma=sigma)(
        jnp.zeros(n, b.dtype), g=g, h=h, K=FirstDifference2D(H=H, W=W), N=1)
    x_dn, _ = ciao_tpu.ChambollePock(maxit=6000, tau=tau, sigma=sigma)(
        jnp.zeros(n, b.dtype), g=g, h=h,
        K=DenseMap(M=jnp.asarray(_dense_tv2d(H, W))), N=1)
    np.testing.assert_allclose(np.asarray(x_st), np.asarray(x_dn),
                               rtol=0, atol=1e-9)
    # blocky: most differences exactly-ish flat, plateaus near truth
    d = np.abs(np.asarray(
        FirstDifference2D(H=H, W=W).matvec(jnp.asarray(x_st))))
    assert np.sum(d > 1e-4) < d.size // 3
    assert np.max(np.abs(np.asarray(x_st) - truth.reshape(-1))) < 0.5


def test_tv2d_condat_vu_with_finite_sum():
    """Condat-Vũ: 2-D TV with the quadratic as the finite-sum smooth
    term (identity rows) must agree with the Chambolle-Pock solution
    of the same objective."""
    from ciao_tpu import FirstDifference2D
    from ciao_tpu.prox import SqrDistPoint

    H, W = 6, 6
    n = H * W
    rng = np.random.default_rng(2)
    truth = np.zeros((H, W))
    truth[:, :3] = 2.0
    b_np = (truth + 0.2 * rng.standard_normal((H, W))).reshape(-1)
    b = jnp.asarray(b_np)
    lam = 0.3
    K = FirstDifference2D(H=H, W=W)
    h = NormL1(lam=jnp.asarray(lam))
    x_cp, _ = ciao_tpu.ChambollePock(maxit=20000)(
        jnp.zeros(n, b.dtype), g=SqrDistPoint(b=b, rho=jnp.asarray(1.0)),
        h=h, K=K, N=1)
    F = LeastSquaresRows(A=jnp.eye(n, dtype=b.dtype), b=b,
                         scale=jnp.asarray(float(n), b.dtype))
    x_cv, _ = ciao_tpu.CondatVu(maxit=20000)(
        jnp.zeros(n, b.dtype), F=F, h=h, K=K,
        L=np.full(n, float(n)), N=n)
    np.testing.assert_allclose(np.asarray(x_cv), np.asarray(x_cp),
                               rtol=0, atol=5e-6)


def _dense_grad2d(H, W):
    """Explicit dense (2HW, HW) padded forward-difference pair."""
    n = H * W
    M = np.zeros((2 * n, n))
    for i in range(H):
        for j in range(W - 1):
            M[i * W + j, i * W + j] = -1.0
            M[i * W + j, i * W + j + 1] = 1.0
    for i in range(H - 1):
        for j in range(W):
            M[n + i * W + j, i * W + j] = -1.0
            M[n + i * W + j, (i + 1) * W + j] = 1.0
    return M


def test_gradient_map_2d_matches_dense_and_adjoint():
    from ciao_tpu import GradientMap2D

    H, W = 5, 7
    K = GradientMap2D(H=H, W=W)
    M = _dense_grad2d(H, W)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(H * W))
    y = jnp.asarray(rng.standard_normal(2 * H * W))
    np.testing.assert_allclose(np.asarray(K.matvec(x)), M @ np.asarray(x),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(K.rmatvec(y)), M.T @ np.asarray(y),
                               rtol=0, atol=1e-12)
    assert abs(float(jnp.vdot(K.matvec(x), y))
               - float(jnp.vdot(x, K.rmatvec(y)))) < 1e-10
    assert np.linalg.norm(M, 2) <= K.opnorm_bound(H * W)


def test_group_norm_l21_prox_closed_form():
    """GroupNormL21 prox = per-pixel block soft-threshold; value and
    prox pinned against the manual pairwise formula, and the prox is
    the exact minimizer (first-order check on a smooth perturbation)."""
    from ciao_tpu import GroupNormL21

    rng = np.random.default_rng(1)
    lam, gamma = 0.7, 0.9
    g = GroupNormL21(lam=jnp.asarray(lam), groups=2)
    u = jnp.asarray(rng.standard_normal(2 * 17))
    p = np.asarray(g.prox_only(u, gamma))
    v = np.asarray(u).reshape(2, -1)
    nrm = np.sqrt((v ** 2).sum(axis=0))
    sc = np.maximum(1 - gamma * lam / np.maximum(nrm, 1e-38), 0.0)
    np.testing.assert_allclose(p.reshape(2, -1), sc * v, rtol=0, atol=1e-7)
    # prox objective: p must beat nearby perturbations
    def obj(z):
        zz = np.asarray(z).reshape(2, -1)
        return (lam * np.sqrt((zz ** 2).sum(axis=0)).sum()
                + np.sum((np.asarray(z) - np.asarray(u)) ** 2) / (2 * gamma))
    for _ in range(6):
        assert obj(p) <= obj(p + 1e-4 * rng.standard_normal(p.shape)) + 1e-12


def test_isotropic_tv_denoise_rotation_fairness():
    """Isotropic TV (GradientMap2D + GroupNormL21) via Chambolle-Pock:
    solves a blocky denoise, and — the property anisotropic TV lacks —
    penalizes a diagonal edge the same as its transpose (the model is
    symmetric under the H↔W flip; check the two solves agree)."""
    from ciao_tpu import GradientMap2D, GroupNormL21
    from ciao_tpu.prox import SqrDistPoint

    H = W = 8
    n = H * W
    rng = np.random.default_rng(2)
    tri = np.tril(np.ones((H, W))) * 1.5            # diagonal edge
    noise = 0.2 * rng.standard_normal((H, W))
    lam = 0.35

    def solve(img):
        b = jnp.asarray(img.reshape(-1))
        x, _ = ciao_tpu.ChambollePock(maxit=8000)(
            jnp.zeros(n, b.dtype), g=SqrDistPoint(b=b, rho=jnp.asarray(1.0)),
            h=GroupNormL21(lam=jnp.asarray(lam), groups=2),
            K=GradientMap2D(H=H, W=W), N=1)
        return np.asarray(x).reshape(H, W)

    x1 = solve(tri + noise)
    x2 = solve((tri + noise).T)
    # transpose-symmetry of the isotropic model (fields swap roles)
    np.testing.assert_allclose(x2.T, x1, rtol=0, atol=5e-5)
    # it denoised: closer to the clean image than the input, and the
    # isotropic TV of the estimate is well below the noisy input's
    assert np.linalg.norm(x1 - tri) < np.linalg.norm(noise)

    def tv_iso(img):
        dh = np.diff(img, axis=1)
        dv = np.diff(img, axis=0)
        return (np.sqrt(dh[:-1] ** 2 + dv[:, :-1] ** 2).sum()
                + np.abs(dh[-1]).sum() + np.abs(dv[:, -1]).sum())

    assert tv_iso(x1) < 0.5 * tv_iso(tri + noise)

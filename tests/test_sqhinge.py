"""Squared-hinge rows (smooth SVM — beyond the reference; its oracle
set has no margin loss and ProximalOperators' HingeLoss is nonsmooth).
Pins: gradients/values vs autodiff, the margin (TP) protocol, the
closed-form per-row prox vs brute force, int8 storage, an L2-SVM
acceptance run (separable
planted data: perfect training classification + the PANOC optimum),
and a sparse-SVM (L1) run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu import SquaredHingeRows
from ciao_tpu.prox import NormL1, SqrNormL2

N, n = 256, 32


@pytest.fixture(scope="module")
def svm_data():
    """Separable two-class data with margin: x* = w_true direction."""
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal(n)
    w_true /= np.linalg.norm(w_true)
    X = rng.standard_normal((N, n)).astype(np.float64)
    m = X @ w_true
    # push points away from the decision boundary (margin >= 0.5)
    X += np.where(m[:, None] >= 0, 0.5, -0.5) * w_true[None, :]
    y = np.sign(X @ w_true)
    return X, y, w_true


def _oracle(X, y, scale=1.0):
    Xa = jnp.asarray(X)
    return SquaredHingeRows(A=Xa, y=jnp.asarray(y),
                            scale=jnp.asarray(scale, Xa.dtype))


def test_grads_match_autodiff(svm_data):
    X, y, _ = svm_data
    F = _oracle(X, y, scale=3.0)

    def f_i(x, i):
        h = jnp.maximum(1.0 - y[i] * (jnp.asarray(X[i]) @ x), 0.0)
        return 0.5 * 3.0 * h * h

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(n))
    for i in (0, 3, 17):
        v, g1 = F.value_and_grad_i(x, i)
        va = f_i(x, i)
        ga = jax.grad(f_i)(x, i)
        np.testing.assert_allclose(float(v), float(va), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(ga),
                                   rtol=1e-9, atol=1e-12)
    # batched/full entry points agree with the per-index one
    idx = jnp.asarray([0, 3, 17, 31])
    vals, grads = F.value_and_grad_batch(x, idx)
    for k, i in enumerate([0, 3, 17, 31]):
        v, g1 = F.value_and_grad_i(x, int(i))
        np.testing.assert_allclose(float(vals[k]), float(v), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(grads[k]), np.asarray(g1),
                                   rtol=1e-12)
    gs = F.grad_sum_all(x)
    ga = sum(F.value_and_grad_i(x, i)[1] for i in range(N))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ga),
                               rtol=1e-8, atol=1e-9)
    vv, gg = F.value_sum_and_grad_sum_all(x)
    np.testing.assert_allclose(float(vv),
                               sum(float(F.value_and_grad_i(x, i)[0])
                                   for i in range(N)), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(gg), np.asarray(ga),
                               rtol=1e-8, atol=1e-9)


def test_margin_protocol_and_coeff(svm_data):
    X, y, _ = svm_data
    F = _oracle(X, y, scale=2.0)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(n))
    r = F.margin_all(x)
    c = F.coeff_from_margin_all(r)
    np.testing.assert_allclose(np.asarray(c), np.asarray(F.coeff_all(x)),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(F.apply_all(c)),
                               np.asarray(F.grad_sum_all(x)), rtol=1e-9)
    np.testing.assert_allclose(
        float(F.value_from_margin_all(r)), float(F.value_sum_all(x)),
        rtol=1e-12,
    )
    # block/batch coeff paths agree
    np.testing.assert_allclose(np.asarray(F.coeff_block(x, 32, 32)),
                               np.asarray(c[32:64]), rtol=1e-12)


def test_pointprox_closed_form_vs_brute(svm_data):
    """θ from the closed-form activity split must minimize the per-row
    prox objective  f_j(z) + ‖z − v‖²/(2γ)  along z = v − γθa (the
    rank-1 geometry: brute force over θ)."""
    X, y, _ = svm_data
    F = _oracle(X, y, scale=2.0)
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.standard_normal(n) * 0.1)
    gamma = 0.3
    c_B = jnp.asarray(rng.standard_normal(4) * 0.5)
    idx = jnp.asarray([1, 5, 9, 40])
    theta, u = F.pointprox_batch(v + gamma * 0, c_B, gamma, idx)
    # NOTE the Point-SAGA contract: prox at z_j = v + γ c_j a_j
    for k in range(4):
        j = int(idx[k])
        a = X[j]
        na2 = float(a @ a)
        mz = float(a @ np.asarray(v)) + gamma * float(c_B[k]) * na2
        grid = np.linspace(-40, 40, 400001)
        # prox objective along the rank-1 line x = z_j − γθa:
        # f(m(θ)) + ‖x − z_j‖²/(2γ) = f(mz − γ‖a‖²θ) + (γ‖a‖²/2)·θ²
        m = mz - gamma * na2 * grid
        h = np.maximum(1.0 - y[j] * m, 0.0)
        obj = 0.5 * 2.0 * h * h + 0.5 * gamma * na2 * grid ** 2
        # stationarity: the minimizer θ* satisfies θ* = c(m(θ*)); our
        # closed form must match the brute-force argmin
        t_star = grid[np.argmin(obj)]
        assert abs(float(theta[k]) - t_star) < 2e-3, (k, float(theta[k]),
                                                      t_star)


def test_l2_svm_acceptance(svm_data):
    """L2-regularized L2-SVM on separable planted data: SAGA and
    Katyusha reach the PANOC optimum and classify the training set
    perfectly; Point-SAGA (closed-form per-row prox) agrees."""
    X, y, _ = svm_data
    F = _oracle(X, y, scale=1.0)
    g = SqrNormL2(lam=jnp.asarray(0.1))
    L = 1.0 * (X * X).sum(axis=1)
    x0 = jnp.zeros(n)

    x_ref, _ = ciao_tpu.PANOC(maxit=80)(x0, F=F, g=g, L=L, N=N)
    acc = np.mean(np.sign(X @ np.asarray(x_ref)) == y)
    assert acc == 1.0, f"training accuracy {acc}"

    x_saga, _ = ciao_tpu.SAGA(maxit=6000)(x0, F=F, g=g, L=L, N=N)
    np.testing.assert_allclose(np.asarray(x_saga), np.asarray(x_ref),
                               rtol=0, atol=2e-4)
    x_kat, _ = ciao_tpu.Katyusha(maxit=60, batch=8, block_sampling=True)(
        x0, F=F, g=g, L=L, N=N)
    np.testing.assert_allclose(np.asarray(x_kat), np.asarray(x_ref),
                               rtol=0, atol=2e-4)
    # Point-SAGA has no composite-g form; on the separable UNregularized
    # problem the closed-form per-row prox must drive the hinge loss to
    # ~0 with a perfect separator
    x_ps, _ = ciao_tpu.PointSAGA(maxit=6000)(x0, F=F, L=L, N=N)
    assert np.mean(np.sign(X @ np.asarray(x_ps)) == y) == 1.0
    # unregularized separable hinge: the loss keeps decaying toward 0
    # as the separator scales — a fixed budget lands near, not at, it
    assert float(F.value_sum_all(x_ps)) / N < 1e-3


def test_sparse_svm_l1(svm_data):
    """L1-regularized squared hinge (sparse SVM): SARAH run produces a
    sparse separator that still classifies perfectly."""
    X, y, w_true = svm_data
    # embed the informative directions in a wider space of nuisance dims
    rng = np.random.default_rng(6)
    X_wide = np.concatenate([X, rng.standard_normal((N, n))], axis=1)
    F = SquaredHingeRows(A=jnp.asarray(X_wide), y=jnp.asarray(y),
                         scale=jnp.asarray(1.0))
    L = 1.0 * (X_wide * X_wide).sum(axis=1)
    x, _ = ciao_tpu.SARAH(maxit=40, batch=16, block_sampling=True,
                          m=N // 16)(
        jnp.zeros(2 * n), F=F, g=NormL1(lam=jnp.asarray(0.02)), L=L, N=N)
    xv = np.asarray(x)
    assert np.mean(np.sign(X_wide @ xv) == y) == 1.0
    # nuisance half is sparser than the informative half
    assert (np.abs(xv[n:]) > 1e-6).sum() < (np.abs(xv[:n]) > 1e-6).sum()


def test_dp_tp_sqhinge_match_single_chip(svm_data):
    """The squared-hinge oracle rides the generic dense-rows protocol,
    so the DP (index-sharded) and TP (2-D-sharded margin) paths must
    reproduce the single-chip SAGA trajectory with no oracle-specific
    code."""
    from ciao_tpu.parallel import (
        DPSAGA, TPSAGA, make_mesh, make_mesh_2d, shard_finite_sum,
        shard_finite_sum_2d,
    )

    X, y, _ = svm_data
    F = _oracle(X, y, scale=1.0)
    g = NormL1(lam=jnp.asarray(0.01))
    L = 1.0 * (X * X).sum(axis=1)
    x0 = jnp.zeros(n)
    x_sc, _ = ciao_tpu.SAGA(maxit=400, batch=8, block_sampling=True)(
        x0, F=F, g=g, L=L, N=N)
    mesh = make_mesh()
    x_dp, _ = DPSAGA(mesh=mesh, maxit=400, batch=8, block_sampling=True)(
        x0, F=shard_finite_sum(F, mesh), g=g, L=L)
    mesh2 = make_mesh_2d(4, 2)
    Fd2 = shard_finite_sum_2d(F, mesh2)
    x_tp, _ = TPSAGA(mesh=mesh2, maxit=400, batch=2)(x0, F=Fd2, g=g, L=L)
    # the sharded RNG streams intentionally differ from single-chip
    # (per-device draws), so pin trajectories where they are defined to
    # agree: TPSAGA at M-agnostic draws == DPSAGA-equivalent is covered
    # in test_parallel; here pin that all three optimize to the SAME
    # regularized optimum (strongly-convex SqrNormL2 objective)
    from ciao_tpu.prox import SqrNormL2 as _S2

    g2 = _S2(lam=jnp.asarray(0.1))
    x_sc2, _ = ciao_tpu.SAGA(maxit=3000, batch=8, block_sampling=True)(
        x0, F=F, g=g2, L=L, N=N)
    mesh = make_mesh()
    x_dp2, _ = DPSAGA(mesh=mesh, maxit=3000, batch=8,
                      block_sampling=True)(
        x0, F=shard_finite_sum(F, mesh), g=g2, L=L)
    x_tp2, _ = TPSAGA(mesh=mesh2, maxit=3000, batch=2)(
        x0, F=Fd2, g=g2, L=L)
    np.testing.assert_allclose(np.asarray(x_dp2), np.asarray(x_sc2),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(np.asarray(x_tp2), np.asarray(x_sc2),
                               rtol=0, atol=5e-4)
    # the L1 runs classify perfectly
    for xv in (x_sc, x_dp, x_tp):
        assert np.mean(np.sign(X @ np.asarray(xv)) == y) == 1.0

    # TPPointSAGA's margin-split θ (pointprox_theta_block) serves the
    # closed-form squared-hinge prox (crashed before round-3 fix)
    from ciao_tpu.parallel import TPPointSAGA

    x_tps, _ = TPPointSAGA(mesh=mesh2, maxit=400, batch=2)(
        x0, F=Fd2, L=L)
    assert np.all(np.isfinite(np.asarray(x_tps)))
    assert np.mean(np.sign(X @ np.asarray(x_tps)) == y) == 1.0


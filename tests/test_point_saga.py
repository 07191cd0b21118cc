"""Point-SAGA (beyond the reference — proximal-point incremental
solver, Defazio NeurIPS 2016). Pins: exact solve on consistent least
squares, fixed-point agreement with FISTA on logistic loss, the
prox-step stability headroom SAGA lacks, storage modes, and the
streaming-API invariants."""

import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows, LogisticRows

N, n = 64, 8


@pytest.fixture(scope="module")
def lsq():
    """Consistent system: b = A·x_true exactly, so argmin = x_true."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, n))
    x_true = rng.standard_normal(n)
    b = A @ x_true
    F = LeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                         scale=jnp.asarray(float(N)))
    L = float(N) * (A * A).sum(axis=1)
    return A, x_true, F, L


def test_point_saga_converges(lsq):
    A, x_true, F, L = lsq
    x, it = ciao_tpu.PointSAGA(maxit=3000)(jnp.zeros(n), F=F, L=L, N=N)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-8
    assert it == 3000
    # minibatch + contiguous-block sampling (slices, no gather)
    x, _ = ciao_tpu.PointSAGA(maxit=1500, batch=8, block_sampling=True)(
        jnp.zeros(n), F=F, L=L, N=N
    )
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-4


def test_point_saga_matches_fista_fixed_point_logistic(lsq):
    """Non-separable logistic loss: the Point-SAGA fixed point equals
    the full-batch FISTA minimizer (the per-row prox Newton solve is
    exact to roundoff)."""
    A, x_true, _, _ = lsq
    rng = np.random.default_rng(1)
    y = np.sign(A @ x_true)
    y[y == 0] = 1
    fl = rng.choice(N, N // 4, replace=False)
    y[fl] = -y[fl]                       # 25% label noise: finite optimum
    F = LogisticRows(X=jnp.asarray(A), y=jnp.asarray(y))
    L = 0.25 * (A * A).sum(axis=1)
    z0 = jnp.zeros(n)
    xf, _ = ciao_tpu.FISTA(maxit=5000)(z0, F=F, L=L, N=N)
    xp, _ = ciao_tpu.PointSAGA(maxit=20000, gamma=1.0)(z0, F=F, N=N)
    np.testing.assert_allclose(np.asarray(xp), np.asarray(xf),
                               rtol=1e-9, atol=1e-11)


def test_point_saga_stability_headroom(lsq):
    """The method's reason to exist, pinned: at 10x SAGA's stable
    stepsize 1/(3 L_max) the prox step stays BOUNDED (error < 1) while
    SAGA diverges by orders of magnitude. Measured: 8.7e-2 vs 1.5e6."""
    A, x_true, F, L = lsq
    gam = 10.0 / (3.0 * float(np.max(L)))
    z0 = jnp.zeros(n)
    xp, _ = ciao_tpu.PointSAGA(maxit=800, gamma=gam)(z0, F=F, L=L, N=N)
    xs, _ = ciao_tpu.SAGA(gamma=gam, maxit=800)(z0, F=F, L=L, N=N)
    err_p = np.linalg.norm(np.asarray(xp) - x_true)
    err_s = np.linalg.norm(np.asarray(xs) - x_true)
    assert err_p < 1.0, err_p
    assert err_s > 1e3 * err_p, (err_p, err_s)


def test_point_saga_rejections(lsq):
    A, x_true, F, L = lsq
    z0 = jnp.zeros(n)
    with pytest.raises(ValueError, match="composite"):
        ciao_tpu.PointSAGA(maxit=2)(
            z0, F=F, g=ciao_tpu.NormL1(lam=jnp.asarray(0.1)), L=L, N=N
        )
    from ciao_tpu.oracles import DiagQuadratic
    Fd = DiagQuadratic(d=jnp.ones((N, n)), q=jnp.ones((N, n)))
    with pytest.raises(ValueError, match="pointprox"):
        ciao_tpu.PointSAGA(maxit=2)(z0, F=Fd, L=np.ones(N), N=N)
    with pytest.raises(ValueError, match="smoothness"):
        ciao_tpu.PointSAGA(maxit=2)(z0, F=F, N=N)


def test_point_saga_iterator_and_resume(lsq, tmp_path):
    from ciao_tpu import checkpoint
    from ciao_tpu.solvers.base import loop, take

    A, x_true, F, L = lsq
    z0 = jnp.zeros(n)
    solver = ciao_tpu.PointSAGA(maxit=5)
    states = list(take(iter(solver.iterator(z0, F=F, L=L, N=N)), 5))
    np.testing.assert_array_equal(np.asarray(states[0].solution), 0.0)
    x_batch, _ = solver(z0, F=F, L=L, N=N)
    np.testing.assert_array_equal(np.asarray(states[-1].solution),
                                  np.asarray(x_batch))
    # checkpoint mid-run, resume: equals the straight-through run
    solver = ciao_tpu.PointSAGA(maxit=40)
    st_full = loop(take(iter(solver.iterator(z0, F=F, L=L, N=N)), 10))
    st_mid = loop(take(iter(solver.iterator(z0, F=F, L=L, N=N)), 5))
    checkpoint.save(tmp_path / "ps.npz", st_mid)
    restored = checkpoint.load(tmp_path / "ps.npz")
    resumed = loop(take(
        checkpoint.resume_iterator(solver.iterator(z0, F=F, L=L, N=N),
                                   restored), 6))
    np.testing.assert_allclose(np.asarray(resumed.x),
                               np.asarray(st_full.x), rtol=1e-12, atol=1e-14)


def test_point_saga_storage_and_complex(lsq):
    A, x_true, F, L = lsq
    z0 = jnp.zeros(n, jnp.float32)
    F32 = LeastSquaresRows(A=jnp.asarray(A, jnp.float32),
                           b=jnp.asarray(A @ x_true, jnp.float32),
                           scale=jnp.asarray(float(N), jnp.float32))
    for st in (jnp.bfloat16, jnp.int8):
        Fs = F32.with_storage(st)
        x, _ = ciao_tpu.PointSAGA(maxit=2000)(z0, F=Fs, L=L, N=N)
        assert x.dtype == jnp.float32
        # converges to the quantized operator's optimum ~ x_true at
        # storage resolution
        tol = 0.15 if st == jnp.int8 else 0.05
        assert np.linalg.norm(np.asarray(x) - x_true) < tol * np.linalg.norm(x_true)

    rng = np.random.default_rng(2)
    Ac = rng.standard_normal((N, n)) + 1j * rng.standard_normal((N, n))
    xc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    Fc = LeastSquaresRows(A=jnp.asarray(Ac), b=jnp.asarray(Ac @ xc),
                          scale=jnp.asarray(float(N)))
    Lc = float(N) * np.abs(Ac * np.conj(Ac)).sum(axis=1)
    x, _ = ciao_tpu.PointSAGA(maxit=4000)(jnp.zeros(n, Fc.A.dtype),
                                          F=Fc, L=Lc, N=N)
    assert x.dtype == Fc.A.dtype
    assert np.linalg.norm(np.asarray(x) - xc) < 1e-6


def test_dp_point_saga(lsq):
    """DPPointSAGA on the 8-device CPU mesh: sharded coefficient
    table, one psum per step; converges to the consistent-system
    optimum (the DP sampling stream differs from single-chip by design,
    as for every DP family — convergence is the contract)."""
    import jax
    from ciao_tpu.parallel import DPPointSAGA, make_mesh, shard_finite_sum

    A, x_true, F, L = lsq
    mesh = make_mesh()
    Fd = shard_finite_sum(F, mesh)
    z0 = jnp.zeros(n)
    x, _ = DPPointSAGA(mesh=mesh, maxit=1500, batch=8)(z0, F=Fd, L=L, N=N)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-4
    with pytest.raises(ValueError, match="composite"):
        DPPointSAGA(mesh=mesh, maxit=2)(
            z0, F=Fd, g=ciao_tpu.NormL1(lam=jnp.asarray(0.1)), L=L, N=N
        )


def test_tp_point_saga_converges_and_shards(lsq):
    """TPPointSAGA on a (4 data x 2 model) mesh: the stacked
    margins+square-norms "model" psum feeds a replicated θ solve; the
    coefficient table stays data-sharded, the iterate model-sharded."""
    from jax.sharding import PartitionSpec as P
    from ciao_tpu.parallel import TPPointSAGA, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    A, x_true, F, L = lsq
    mesh2 = make_mesh_2d(4, 2)
    F2 = shard_finite_sum_2d(F, mesh2)
    z0 = jnp.zeros(n)
    solver = TPPointSAGA(mesh=mesh2, maxit=1500, batch=4)
    x, _ = solver(z0, F=F2, L=L, N=N)
    assert np.linalg.norm(np.asarray(x) - x_true) < 1e-4
    st = next(iter(solver.iterator(z0, F=F2, L=L, N=N)))
    assert st.x.sharding.spec == P(MODEL_AXIS)
    assert st.c.sharding.spec == P(DATA_AXIS)
    with pytest.raises(ValueError, match="composite"):
        TPPointSAGA(mesh=mesh2, maxit=2)(
            z0, F=F2, g=ciao_tpu.NormL1(lam=jnp.asarray(0.1)), L=L, N=N
        )


def test_point_saga_huber_pointprox():
    """Huber-row Point-SAGA (round 3): the closed-form per-row prox
    θ = clip(scale·r₀/(1+scale·γ‖a‖²), ±scale·δ) must minimize the
    rank-1 prox objective (brute force), and the tensor-parallel facade
    must run on the margin-split θ."""
    from ciao_tpu.oracles import HuberRows

    rng = np.random.default_rng(0)
    Np, npix, Bp = 1024, 128, 128
    X = rng.standard_normal((Np, npix)).astype(np.float32)
    bv = rng.standard_normal(Np).astype(np.float32)
    delta, scale = 0.7, 2.0
    F = HuberRows(A=jnp.asarray(X), b=jnp.asarray(bv),
                  delta=jnp.asarray(np.float32(delta)),
                  scale=jnp.asarray(np.float32(scale)))

    # brute-force the rank-1 prox objective along θ
    v = jnp.asarray(rng.standard_normal(npix).astype(np.float32) * 0.1)
    gamma = 0.3
    c_B = jnp.asarray(rng.standard_normal(4).astype(np.float32) * 0.5)
    idx = jnp.asarray([1, 5, 9, 40])
    theta, _ = F.pointprox_batch(v, c_B, gamma, idx)
    for k in range(4):
        j = int(idx[k])
        a = X[j].astype(np.float64)
        na2 = float(a @ a)
        mz = float(a @ np.asarray(v, np.float64)) \
            + gamma * float(c_B[k]) * na2
        grid = np.linspace(-10, 10, 400001)
        r = (mz - gamma * na2 * grid) - float(bv[j])
        ar = np.abs(r)
        f = scale * np.where(ar <= delta, 0.5 * r * r,
                             delta * (ar - 0.5 * delta))
        obj = f + 0.5 * gamma * na2 * grid ** 2
        t_star = grid[np.argmin(obj)]
        assert abs(float(theta[k]) - t_star) < 2e-3, (k, float(theta[k]),
                                                      t_star)

    L = scale * (X * X).sum(axis=1)
    x0 = jnp.zeros(npix, jnp.float32)

    # TPPointSAGA consumes the margin-split θ (pointprox_theta_block)
    from ciao_tpu.parallel import TPPointSAGA, make_mesh_2d, shard_finite_sum_2d

    mesh2 = make_mesh_2d(4, 2)
    x_tp, _ = TPPointSAGA(mesh=mesh2, maxit=50, batch=2)(
        x0, F=shard_finite_sum_2d(F, mesh2), L=L)
    assert np.all(np.isfinite(np.asarray(x_tp)))


def test_point_saga_importance_facade_converges_and_guards():
    """Facade-level: importance_sampling=True on an ill-conditioned
    CONSISTENT least-squares system (Point-SAGA has no composite-g
    form) converges at a matched budget much closer than uniform (hot
    anchors refresh more often; γ scales with the clipped EFFECTIVE
    smoothness instead of max L); guards reject the invalid combos."""
    import ciao_tpu

    Np, npx = 1024, 64
    rng = np.random.default_rng(1)
    # log-uniform row scales 1..~30 → ~7.6x block-L spread (the
    # reference generator's L spread is only ~1.4x at block level —
    # too narrow to separate the schedules)
    scale_row = 10.0 ** (1.5 * np.arange(Np) / (Np - 1))
    A = rng.standard_normal((Np, npx)) * scale_row[:, None]
    x_true = rng.standard_normal(npx)
    b = A @ x_true                       # consistent: argmin unique, f*=0
    L = Np * (A * A).sum(axis=1)
    F = LeastSquaresRows(
        A=jnp.asarray(A), b=jnp.asarray(b), scale=jnp.asarray(float(Np)))
    z0 = jnp.zeros(npx, A.dtype)
    steps = 16000
    xu, _ = ciao_tpu.PointSAGA(maxit=steps, batch=8, block_sampling=True)(
        z0, F=F, L=L, N=Np)
    xi, _ = ciao_tpu.PointSAGA(maxit=steps, batch=8, block_sampling=True,
                               importance_sampling=True)(
        z0, F=F, L=L, N=Np)
    gap_u = float(np.sum((A @ np.asarray(xu) - b) ** 2))
    gap_i = float(np.sum((A @ np.asarray(xi) - b) ** 2))
    # measured ~750x; assert two orders with slack
    assert gap_i * 100 < gap_u, (gap_i, gap_u)

    with pytest.raises(ValueError, match="block_sampling"):
        ciao_tpu.PointSAGA(maxit=2, importance_sampling=True)(
            z0, F=F, L=L, N=Np)
    with pytest.raises(ValueError, match="provide L"):
        ciao_tpu.PointSAGA(maxit=2, batch=8, block_sampling=True,
                           importance_sampling=True, gamma=0.1)(
            z0, F=F, N=Np)

"""Unit tests for the smooth-term oracles: every batched path must
agree with per-index autodiff ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ciao_tpu import oracles


def _autodiff_check(oracle, funs, x, atol=1e-8):
    """funs[i](x) must match oracle term i in value and grad."""
    N = oracle.num_terms
    for i in range(N):
        v, g = oracle.value_and_grad_i(x, jnp.asarray(i))
        v_ref = funs[i](x)
        g_ref = jax.grad(funs[i])(x)
        np.testing.assert_allclose(v, v_ref, atol=atol, rtol=1e-6)
        np.testing.assert_allclose(g, g_ref, atol=atol, rtol=1e-6)


def _batched_paths_consistent(oracle, x, atol=1e-8):
    N = oracle.num_terms
    idx = jnp.arange(N)
    vals_i, grads_i = zip(
        *[oracle.value_and_grad_i(x, jnp.asarray(i)) for i in range(N)]
    )
    G_ref = jnp.stack(grads_i)
    vals, G = oracle.value_and_grad_batch(x, idx)
    np.testing.assert_allclose(G, G_ref, atol=atol, rtol=1e-6)
    np.testing.assert_allclose(vals, jnp.stack(vals_i), atol=atol, rtol=1e-6)
    np.testing.assert_allclose(
        oracle.grad_sum_all(x), jnp.sum(G_ref, axis=0), atol=atol, rtol=1e-6
    )
    np.testing.assert_allclose(
        oracle.grad_all(x), G_ref, atol=atol, rtol=1e-6
    )
    # masked block sum
    mask = jnp.array([True] * (N - 1) + [False])
    np.testing.assert_allclose(
        oracle.grad_sum_batch(x, idx, mask),
        jnp.sum(G_ref[:-1], axis=0),
        atol=atol,
        rtol=1e-6,
    )
    # grad_sum_diff
    x2 = x + 0.37
    np.testing.assert_allclose(
        oracle.grad_sum_diff(x, x2, idx),
        oracle.grad_sum_batch(x, idx) - oracle.grad_sum_batch(x2, idx),
        atol=atol,
        rtol=1e-6,
    )
    # pointwise path at distinct eval points
    xs = jnp.stack([x + 0.1 * i for i in range(N)])
    Gp = oracle.grad_pointwise(xs, idx)
    Gp_ref = jnp.stack(
        [oracle.value_and_grad_i(xs[i], jnp.asarray(i))[1] for i in range(N)]
    )
    np.testing.assert_allclose(Gp, Gp_ref, atol=atol, rtol=1e-6)


def test_least_squares_rows():
    rng = np.random.default_rng(0)
    N, n = 5, 4
    A = jnp.asarray(rng.standard_normal((N, n)))
    b = jnp.asarray(rng.standard_normal(N))
    orc = oracles.LeastSquaresRows(A=A, b=b, scale=jnp.asarray(float(N)))
    x = jnp.asarray(rng.standard_normal(n))
    funs = [
        (lambda x, i=i: 0.5 * N * (A[i] @ x - b[i]) ** 2) for i in range(N)
    ]
    _autodiff_check(orc, funs, x)
    _batched_paths_consistent(orc, x)


def test_least_squares_complex():
    rng = np.random.default_rng(1)
    N, n = 4, 3
    A = jnp.asarray(rng.standard_normal((N, n)) + 0j)
    b = jnp.asarray(rng.standard_normal(N) + 0j)
    orc = oracles.LeastSquaresRows(A=A, b=b, scale=jnp.asarray(1.0))
    x = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    # Wirtinger gradient of (1/2)|a·x-b|^2 w.r.t. x is conj(a)(a·x-b)
    for i in range(N):
        v, g = orc.value_and_grad_i(x, jnp.asarray(i))
        r = A[i] @ x - b[i]
        np.testing.assert_allclose(v, 0.5 * np.abs(r) ** 2, atol=1e-10)
        np.testing.assert_allclose(g, np.conj(A[i]) * r, atol=1e-10)
    _batched_paths_consistent(orc, x)


def test_logistic_rows():
    rng = np.random.default_rng(2)
    N, n = 6, 3
    X = jnp.asarray(rng.standard_normal((N, n)))
    y = jnp.asarray(np.where(rng.random(N) > 0.5, 1.0, -1.0))
    orc = oracles.LogisticRows(X=X, y=y)
    x = jnp.asarray(rng.standard_normal(n))
    funs = [
        (lambda x, i=i: jnp.logaddexp(0.0, -y[i] * (X[i] @ x))) for i in range(N)
    ]
    _autodiff_check(orc, funs, x)
    _batched_paths_consistent(orc, x)


def test_diag_quadratic_and_sqrdist_sum():
    rng = np.random.default_rng(3)
    N, n = 3, 2
    d = jnp.asarray(rng.standard_normal((N, n)))
    q = jnp.asarray(rng.standard_normal((N, n)))
    quad = oracles.DiagQuadratic(d=d, q=q)
    x = jnp.asarray(rng.standard_normal(n))
    funs = [
        (lambda x, i=i: 0.5 * x @ (d[i] * x) + q[i] @ x) for i in range(N)
    ]
    _autodiff_check(quad, funs, x)
    _batched_paths_consistent(quad, x)

    sq = oracles.SqrDistBox(
        lo=jnp.asarray(-1.0), hi=jnp.asarray(1.0), eta=jnp.asarray(5.0), n_terms=N
    )
    sfuns = [
        (
            lambda x, i=i: 2.5
            * jnp.sum((x - jnp.clip(x, -1.0, 1.0)) ** 2)
        )
        for i in range(N)
    ]
    _autodiff_check(sq, sfuns, jnp.asarray([3.0, -0.5]))

    both = oracles.SumOracle(terms=(quad, sq))
    bfuns = [(lambda x, i=i: funs[i](x) + sfuns[i](x)) for i in range(N)]
    _autodiff_check(both, bfuns, x)
    _batched_paths_consistent(both, x)


def test_custom_oracle_matches_handwritten():
    rng = np.random.default_rng(4)
    N, n = 5, 4
    A = rng.standard_normal((N, n))
    b = rng.standard_normal(N)
    custom = oracles.CustomOracle(
        data={"a": jnp.asarray(A), "b": jnp.asarray(b)},
        fun=lambda x, d: 0.5 * (d["a"] @ x - d["b"]) ** 2,
    )
    hand = oracles.LeastSquaresRows(
        A=jnp.asarray(A), b=jnp.asarray(b), scale=jnp.asarray(1.0)
    )
    x = jnp.asarray(rng.standard_normal(n))
    assert custom.num_terms == N
    for i in range(N):
        v1, g1 = custom.value_and_grad_i(x, jnp.asarray(i))
        v2, g2 = hand.value_and_grad_i(x, jnp.asarray(i))
        np.testing.assert_allclose(v1, v2, atol=1e-10)
        np.testing.assert_allclose(g1, g2, atol=1e-10)


def test_oracles_are_pytrees():
    orc = oracles.LeastSquaresRows(
        A=jnp.ones((3, 2)), b=jnp.zeros(3), scale=jnp.asarray(3.0)
    )
    leaves, treedef = jax.tree_util.tree_flatten(orc)
    assert len(leaves) == 3
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(rebuilt, oracles.LeastSquaresRows)

    # jit with the oracle as an argument must not error
    @jax.jit
    def f(o, x):
        return o.grad_sum_all(x)

    np.testing.assert_allclose(f(orc, jnp.ones(2)), orc.grad_sum_all(jnp.ones(2)))


def test_precompose_matches_folded_logistic():
    """Precompose(scalar logistic, a_i^T rows) == LogisticRows — the
    reference's construction (test_logistic_l1.jl:36) through the
    general combinator."""
    import dataclasses as dc
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ciao_tpu.oracles import CustomOracle, LogisticRows, Precompose

    rng = np.random.default_rng(0)
    N, n = 6, 4
    X = rng.standard_normal((N, n))
    y = np.sign(rng.standard_normal(N))
    # base: scalar logistic loss on the 1-d precomposed value
    base = CustomOracle(
        data={"y": jnp.asarray(y)},
        fun=lambda v, d: jnp.logaddexp(0.0, -d["y"] * v[0]),
    )
    pre = Precompose(base=base, Lmat=jnp.asarray(X)[:, None, :])
    folded = LogisticRows(X=jnp.asarray(X), y=jnp.asarray(y))
    x = jnp.asarray(rng.standard_normal(n))
    for i in range(N):
        v1, g1 = pre.value_and_grad_i(x, i)
        v2, g2 = folded.value_and_grad_i(x, i)
        np.testing.assert_allclose(float(v1), float(v2), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-10)


def test_with_storage_rejects_unknown_mode():
    """``with_storage`` accepts dtype aliases via a single shared parser
    (oracles.base.parse_storage_dtype) and raises a ValueError listing
    the supported modes for anything else."""
    F = oracles.LeastSquaresRows(
        A=jnp.ones((4, 4), jnp.float32), b=jnp.ones(4, jnp.float32),
        scale=jnp.asarray(4.0, jnp.float32),
    )
    assert F.with_storage("float32").A.dtype == jnp.float32
    assert F.with_storage("fp32").A.dtype == jnp.float32
    assert F.with_storage("i8").A.dtype == jnp.int8
    with pytest.raises(ValueError, match="storage mode"):
        F.with_storage("fp8")


def test_huber_rows():
    """HuberRows (beyond the reference's oracle set): per-index values
    and gradients vs autodiff, all batched paths, the rank-1
    coefficient structure, and the TP margin/coeff split — at residuals
    straddling the δ threshold so both branches are exercised."""
    rng = np.random.default_rng(4)
    N, n = 10, 4
    A = jnp.asarray(rng.standard_normal((N, n)))
    b = jnp.asarray(rng.standard_normal(N) * 2.0)  # some |r| > delta
    delta, scale = 0.7, float(N)
    orc = oracles.HuberRows(
        A=A, b=b, delta=jnp.asarray(delta), scale=jnp.asarray(scale)
    )
    x = jnp.asarray(rng.standard_normal(n))

    def make_f(i):
        def f(x):
            r = A[i] @ x - b[i]
            return scale * jnp.where(
                jnp.abs(r) <= delta, 0.5 * r * r,
                delta * (jnp.abs(r) - 0.5 * delta),
            )
        return f

    funs = [make_f(i) for i in range(N)]
    _autodiff_check(orc, funs, x)
    _batched_paths_consistent(orc, x)

    # rank-1 coefficient structure and the TP margin split
    c = orc.coeff_all(x)
    np.testing.assert_allclose(orc.grad_all(x), np.asarray(c)[:, None] * A,
                               atol=1e-10)
    np.testing.assert_allclose(orc.coeff_from_margin_all(orc.margin_all(x)),
                               c, atol=1e-12)
    np.testing.assert_allclose(orc.coeff_block(x, 2, 4), c[2:6], atol=1e-12)
    np.testing.assert_allclose(orc.apply_rows_block(c[2:6], 2, 4),
                               np.asarray(c[2:6]) @ np.asarray(A[2:6]),
                               atol=1e-10)

    # bf16 storage round-trips the API; int8 keeps per-row scales exact
    o16 = orc.with_storage()
    assert o16.A.dtype == jnp.bfloat16
    oq = orc.with_storage("int8")
    assert oq.A.dtype == jnp.int8
    cq = oq.coeff_all(x.astype(jnp.float32))
    assert np.isfinite(np.asarray(cq)).all()


def test_huber_end_to_end_robustness():
    """Huber regression end-to-end through four solver families: all
    converge to the SAME optimum (cross-solver fixed-point agreement at
    1e-6), and that optimum is robust — closer in x-space to the clean
    planted signal than the least-squares solution when outliers
    corrupt 10% of the targets."""
    import ciao_tpu

    rng = np.random.default_rng(7)
    N, n = 128, 8
    A = rng.standard_normal((N, n))
    x_true = rng.standard_normal(n)
    y = A @ x_true + 0.01 * rng.standard_normal(N)
    out = rng.choice(N, size=N // 10, replace=False)
    y[out] += 40.0 * rng.standard_normal(out.size)  # gross outliers

    delta = 0.5
    F = ciao_tpu.HuberRows(
        A=jnp.asarray(A), b=jnp.asarray(y), delta=jnp.asarray(delta),
        scale=jnp.asarray(float(N)),
    )
    L = float(N) * (A * A).sum(axis=1)
    z0 = jnp.zeros(n)

    xs = {}
    xs["saga"], _ = ciao_tpu.SAGA(maxit=40000)(z0, F=F, L=L, N=N)
    xs["finito"], _ = ciao_tpu.Finito(maxit=20000, sweeping=2)(
        z0, F=F, L=L, N=N
    )
    xs["svrg"], _ = ciao_tpu.SVRG(
        maxit=300, m=N, gamma=1.0 / (10 * max(L))
    )(z0, F=F, L=L, N=N)
    xs["katyusha"], _ = ciao_tpu.Katyusha(maxit=200)(z0, F=F, L=L, N=N)
    ref = np.asarray(xs["katyusha"])
    for name, x in xs.items():
        np.testing.assert_allclose(np.asarray(x), ref, atol=1e-5, err_msg=name)

    # robustness vs plain least squares on the corrupted targets
    x_ls = np.linalg.lstsq(A, y, rcond=None)[0]
    assert np.linalg.norm(ref - x_true) < 0.25 * np.linalg.norm(x_ls - x_true)

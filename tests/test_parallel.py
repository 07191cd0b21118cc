"""Distributed (sharded) solver tests on a virtual 8-device CPU mesh.

The reference has NO distributed tests (single-process Julia; SURVEY.md
§4 flags this as the gap our build fills). These tests run the shard_map
DP paths over ``--xla_force_host_platform_device_count=8`` and assert

  * convergence to the planted optimum at the reference's tolerances
    on a larger synthesized Lasso (the reference generator at any scale,
    test_lasso.jl:14-47 construction);
  * the sharded-state layout (tables really sharded over the data axis);
  * DP/single-chip solution agreement;
  * ProShI coupling convergence on a block-replicated sharing problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import ciao_tpu
from ciao_tpu.oracles import DiagQuadratic, LeastSquaresRows, SqrDistBox, SumOracle
from ciao_tpu.parallel import (
    DATA_AXIS,
    DPFinito,
    DPProshi,
    DPSAG,
    DPSAGA,
    DPSVRG,
    make_mesh,
    shard_finite_sum,
)
from ciao_tpu.prox import IndBox, NormL1
from ciao_tpu.utils.problems import make_lasso

N, n = 64, 8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh()


@pytest.fixture(scope="module")
def lasso(mesh):
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum(F, mesh)
    g = NormL1(lam=jnp.asarray(prob.lam))
    return prob, F, g


def x0(prob):
    return jnp.zeros(prob.A.shape[1], prob.A.dtype)


def test_oracle_sharding_layout(mesh, lasso):
    prob, F, g = lasso
    spec = F.A.sharding.spec
    assert spec == P(DATA_AXIS, None)
    assert F.b.sharding.spec == P(DATA_AXIS)


def test_dp_finito_basic_converges(mesh, lasso):
    prob, F, g = lasso
    solver = DPFinito(mesh=mesh, maxit=2000, batch=8, sweeping=1)
    x, it = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


@pytest.mark.parametrize("sweeping", [2, 3])
def test_dp_finito_sweeps(mesh, lasso, sweeping):
    prob, F, g = lasso
    solver = DPFinito(mesh=mesh, maxit=2000, batch=16, sweeping=sweeping)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_finito_table_sharded(mesh, lasso):
    prob, F, g = lasso
    it = DPFinito(mesh=mesh, batch=8).iterator(x0(prob), F=F, g=g, L=prob.L)
    state = next(iter(it))
    assert state.s.shape == (N, n)
    assert state.s.sharding.spec == P(DATA_AXIS, None)
    assert state.gamma.sharding.spec == P(DATA_AXIS)


def test_dp_lfinito_converges(mesh, lasso):
    prob, F, g = lasso
    solver = DPFinito(mesh=mesh, LFinito=True, maxit=200, batch=8, sweeping=3)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_saga_converges(mesh, lasso):
    prob, F, g = lasso
    solver = DPSAGA(mesh=mesh, maxit=3000, batch=8)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_sag_converges(mesh, lasso):
    prob, F, g = lasso
    solver = DPSAG(mesh=mesh, maxit=20000, batch=16)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_svrg_converges(mesh, lasso):
    prob, F, g = lasso
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    solver = DPSVRG(mesh=mesh, maxit=500, batch=8, m=N, gamma=gamma)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_matches_single_chip(mesh, lasso):
    """DP and single-chip minibatch solvers agree on the solution (same
    optimum at tolerance; trajectories differ by sampling)."""
    prob, F, g = lasso
    x_dp, _ = DPFinito(mesh=mesh, maxit=2000, batch=8)(
        x0(prob), F=F, g=g, L=prob.L
    )
    x_sc, _ = ciao_tpu.Finito(maxit=2000, minibatch=(True, 8))(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    np.testing.assert_allclose(np.asarray(x_dp), np.asarray(x_sc), atol=2e-3)


def test_dp_deterministic(mesh, lasso):
    """Stateless (key, it, device) schedules: same seed -> identical run."""
    prob, F, g = lasso
    a, _ = DPSAGA(mesh=mesh, maxit=200, batch=8, seed=7)(x0(prob), F=F, g=g, L=prob.L)
    b, _ = DPSAGA(mesh=mesh, maxit=200, batch=8, seed=7)(x0(prob), F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dp_iterator_streaming(mesh, lasso):
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    solver = DPFinito(mesh=mesh, batch=8, maxit=50)
    states = list(take(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)), 5))
    assert len(states) == 5
    assert int(states[-1].it) == 5


def test_dp_validation_errors(mesh, lasso):
    prob, F, g = lasso
    with pytest.raises(ValueError, match="divide evenly"):
        DPFinito(mesh=mesh)(jnp.zeros(n), F=F, g=g, L=prob.L, N=63)
    with pytest.raises(ValueError, match="divisible by D"):
        DPFinito(mesh=mesh, batch=12)(x0(prob), F=F, g=g, L=prob.L, N=N)


# ---------------------------------------------------------------------------
# sharing problem (ProShI) — block-parallel coupling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharing(mesh):
    """A 24-block sharing problem: the reference's 3 blocks
    (test_sharing.jl:13-24) replicated 8x; the coupling optimum is found
    with the single-chip solver and used as the DP target."""
    reps = 8
    rng = np.random.default_rng(0)
    base_d = np.array([[1.0, 2.0], [-1.0, 3.0], [0.0, 10.0]])
    d = np.tile(base_d, (reps, 1))
    q = np.ones_like(d)
    Nb, nb = d.shape
    eta = Nb * 10.0
    L = np.abs(d).max(axis=1) + eta
    F = SumOracle(
        terms=(
            DiagQuadratic(d=jnp.asarray(d), q=jnp.asarray(q)),
            SqrDistBox(
                lo=jnp.asarray(-2.0), hi=jnp.asarray(2.0),
                eta=jnp.asarray(eta), n_terms=Nb,
            ),
        )
    )
    g = IndBox(lo=-jnp.inf, hi=jnp.asarray(np.ones(nb)))
    # batch-8 reference: the nonconvex block (d_2 = (-1, 3), as in the
    # reference problem) means batch-1 and batch-8 sweeps select
    # different stationary points — parity is defined at MATCHED batch
    # size (the reference's own minibatch mode, ProShI.jl:27).
    x_ref, _ = ciao_tpu.Proshi(maxit=10000, minibatch=(True, 8))(
        jnp.zeros(nb), F=F, g=g, L=jnp.asarray(L), N=Nb
    )
    sum_ref = np.asarray(jnp.sum(x_ref, axis=0))
    F_sharded = shard_finite_sum(F, mesh, N=Nb)
    return F_sharded, g, L, Nb, nb, sum_ref


def test_dp_proshi_converges(mesh, sharing):
    F, g, L, Nb, nb, sum_ref = sharing
    solver = DPProshi(mesh=mesh, maxit=10000, batch=8)
    x, _ = solver(jnp.zeros(nb), F=F, g=g, L=jnp.asarray(L), N=Nb)
    assert x.shape == (Nb, nb)
    got = np.asarray(jnp.sum(x, axis=0))
    np.testing.assert_allclose(got, sum_ref, atol=2e-2)
    # the coupling constraint g = IndBox(-inf, 1) must hold
    assert np.all(got <= 1.0 + 1e-6)


def test_dp_saga_coeff_matches_full(mesh, lasso):
    """DP coefficient table == DP full table exactly (same sampling
    stream, algebraic compression), sharded P('data')."""
    prob, F, g = lasso
    a, _ = DPSAGA(mesh=mesh, maxit=500, batch=16, block_sampling=True,
                  table="full", seed=3)(x0(prob), F=F, g=g, L=prob.L)
    solver = DPSAGA(mesh=mesh, maxit=500, batch=16, block_sampling=True,
                    table="coeff", seed=3)
    b, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.s.shape == (N,)
    assert st.s.sharding.spec == P(DATA_AXIS)


def test_dp_saga_coeff_converges(mesh, lasso):
    prob, F, g = lasso
    x, _ = DPSAGA(mesh=mesh, maxit=3000, batch=8, block_sampling=True)(
        x0(prob), F=F, g=g, L=prob.L
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


# ---------------------------------------------------------------------------
# tensor-parallel (coordinate-sharded) path — 2-D ("data", "model") mesh
# ---------------------------------------------------------------------------

def test_tp_saga_converges_and_shards():
    """TPSAGA on a (4 data x 2 model) mesh: z/av sharded by coordinate,
    coefficient table by sample block; converges to the planted optimum."""
    from ciao_tpu.parallel import TPSAGA, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS  # noqa

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum_2d(F, mesh2)
    assert F.A.sharding.spec == P(DATA_AXIS, MODEL_AXIS)
    g = NormL1(lam=jnp.asarray(prob.lam))
    solver = TPSAGA(mesh=mesh2, maxit=3000, batch=4)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.z.sharding.spec == P(MODEL_AXIS)
    assert st.av.sharding.spec == P(MODEL_AXIS)
    assert st.s.sharding.spec == P(DATA_AXIS)


def test_tp_saga_rejects_nonseparable_prox():
    from ciao_tpu.parallel import TPSAGA, make_mesh_2d
    from ciao_tpu.prox import NormL2

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    with pytest.raises(ValueError, match="separable"):
        TPSAGA(mesh=mesh2)(x0(prob), F=F, g=NormL2(lam=jnp.asarray(1.0)), L=prob.L)


def test_dp_finito_coeff_matches_full(mesh, lasso):
    """DP Finito coefficient mode == full-table mode exactly (same
    schedule, algebraic compression), with sharded anchors."""
    prob, F, g = lasso
    a, _ = DPFinito(mesh=mesh, maxit=500, batch=16, sweeping=3,
                    table="full", seed=2)(x0(prob), F=F, g=g, L=prob.L)
    solver = DPFinito(mesh=mesh, maxit=500, batch=16, sweeping=3,
                      table="coeff", seed=2)
    b, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-11, atol=1e-11)
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.c.shape == (N,)
    assert st.c.sharding.spec == P(DATA_AXIS)
    assert st.zb.sharding.spec == P(DATA_AXIS, None)


def test_tp_finito_converges_and_shards():
    """TPFinito on a (4 data x 2 model) mesh: coefficient table and
    stepsize sums by sample block, anchors by both axes, z/av by
    coordinate; converges to the planted optimum for all 3 sweeps."""
    from ciao_tpu.parallel import TPFinito, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum_2d(F, mesh2)
    g = NormL1(lam=jnp.asarray(prob.lam))
    for sweeping in (1, 2, 3):
        solver = TPFinito(mesh=mesh2, maxit=800, batch=4, sweeping=sweeping)
        x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4, sweeping
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.z.sharding.spec == P(MODEL_AXIS)
    assert st.c.sharding.spec == P(DATA_AXIS)
    assert st.zb.sharding.spec == P(DATA_AXIS, MODEL_AXIS)
    assert st.invg.sharding.spec == P(DATA_AXIS)


def test_tp_finito_rejects_nonseparable_prox():
    from ciao_tpu.parallel import TPFinito, make_mesh_2d
    from ciao_tpu.prox import NormL2

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    with pytest.raises(ValueError, match="separable"):
        TPFinito(mesh=mesh2)(
            x0(prob), F=F, g=NormL2(lam=jnp.asarray(1.0)), L=prob.L
        )


def test_dp_saga_bf16_storage(mesh):
    """bf16-stored rows shard and solve through the DP path: the
    sharded dynamic-slice / matmul steps promote bf16·f32 to f32, and
    the collective traffic (one x-sized psum) is unchanged."""
    prob = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A, jnp.float32),
        b=jnp.asarray(prob.b, jnp.float32),
        scale=jnp.asarray(float(N), jnp.float32),
    ).with_storage()
    F = shard_finite_sum(F, mesh)
    assert F.A.dtype == jnp.bfloat16
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    x, _ = DPSAGA(mesh=mesh, maxit=6000, batch=8)(
        jnp.zeros(n, jnp.float32), F=F, g=g, L=prob.L
    )
    assert x.dtype == jnp.float32
    rel = (prob.cost(np.asarray(x)) - prob.f_star) / abs(prob.f_star)
    assert rel < 2e-2, rel  # bf16 gradient-resolution floor


# ---------------------------------------------------------------------------
# sparse oracles under DP (rcv1-scale layouts over the data axis)
# ---------------------------------------------------------------------------

def test_dp_sparse_matches_dense(mesh):
    """ELL and hybrid oracles drive the DP paths down the SAME
    trajectory as the dense oracle (same math, sharded layout)."""
    from ciao_tpu.oracles import HybridSparseLeastSquares, SparseLeastSquaresELL

    rng = np.random.default_rng(11)
    Np, npx = 128, 32
    A = np.zeros((Np, npx))
    hot = [3, 9, 20]
    for c in hot:
        m = rng.random(Np) < 0.9
        A[m, c] = rng.standard_normal(m.sum())
    cold = np.setdiff1d(np.arange(npx), hot)
    for i in range(Np):
        cs = rng.choice(cold, size=rng.integers(1, 5), replace=False)
        A[i, cs] = rng.standard_normal(len(cs))
    b = A @ rng.standard_normal(npx)
    L = (A ** 2).sum(axis=1) * Np
    g = NormL1(lam=jnp.asarray(0.02))

    Fd = LeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                          scale=jnp.asarray(float(Np)))
    Fe = SparseLeastSquaresELL.from_dense(A, b, float(Np))
    Fh = HybridSparseLeastSquares.from_dense(A, b, float(Np), D=3)

    # N == hot_width == 128: the dp_replicated override must keep
    # hot_cols replicated despite the shape collision
    Fh_sh = shard_finite_sum(Fh, mesh)
    assert Fh.hot_width == Np
    assert Fh_sh.hot_cols.sharding.spec == P()
    assert Fh_sh.A_hot.sharding.spec == P(DATA_AXIS, None)
    assert Fh_sh.idx.sharding.spec == P(DATA_AXIS, None)

    outs = []
    for F in (Fd, Fe, Fh):
        F = shard_finite_sum(F, mesh)
        x, _ = DPSAGA(mesh=mesh, maxit=300, batch=16,
                      block_sampling=True)(jnp.zeros(npx), F=F, g=g, L=L)
        outs.append(np.asarray(x))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-9, atol=1e-9)

    outs = []
    for F in (Fd, Fe, Fh):
        F = shard_finite_sum(F, mesh)
        x, _ = DPFinito(mesh=mesh, maxit=300, batch=16, sweeping=3)(
            jnp.zeros(npx), F=F, g=g, L=L)
        outs.append(np.asarray(x))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-9, atol=1e-9)


def test_dp_sparse_lfinito_and_svrg_match_dense(mesh):
    """The full-pass DP families (LFinito epochs, SVRG anchors) hit the
    sparse oracles' grad_sum_all / grad_sum_diff paths."""
    from ciao_tpu.oracles import HybridSparseLeastSquares

    rng = np.random.default_rng(13)
    Np, npx = 64, 16
    A = rng.standard_normal((Np, npx)) * (rng.random((Np, npx)) < 0.3)
    A[:, 2] = rng.standard_normal(Np)  # one hot column
    b = A @ rng.standard_normal(npx)
    L = (A ** 2).sum(axis=1) * Np
    g = NormL1(lam=jnp.asarray(0.02))
    Fd = LeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                          scale=jnp.asarray(float(Np)))
    Fh = HybridSparseLeastSquares.from_dense(A, b, float(Np), D=1)

    for make in (lambda m: DPFinito(mesh=m, maxit=20, batch=8, LFinito=True,
                                    sweeping=2),
                 lambda m: DPSVRG(mesh=m, maxit=5, batch=8, m=4)):
        outs = []
        for F in (Fd, Fh):
            F = shard_finite_sum(F, mesh)
            x, _ = make(mesh)(jnp.zeros(npx), F=F, g=g, L=L)
            outs.append(np.asarray(x))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-9, atol=1e-9)


def test_dp_rebase_storage_switch(mesh, lasso):
    """DP staged-precision recipe: resume an int8-stage DP state under
    the f32 oracle with ``rebase=True`` — the sharded rebase must
    recompute av from the local coefficient shards (apply + psum; cf.
    ``test_saga_rebase_storage_switch``) and the finished run must reach
    the reference tolerance."""
    from ciao_tpu.checkpoint import resume_iterator
    from ciao_tpu.solvers.base import loop, take

    prob, F, g = lasso
    Fq = shard_finite_sum(F.with_storage("int8"), mesh)
    assert Fq.A.dtype == jnp.int8
    assert Fq.row_scale.sharding.spec == P(DATA_AXIS)

    solver = DPSAGA(mesh=mesh, maxit=4000, batch=16, block_sampling=True,
                    table="coeff", seed=3)
    st = loop(take(iter(solver.iterator(x0(prob), F=Fq, g=g, L=prob.L)), 500))
    it_f32 = solver.iterator(x0(prob), F=F, g=g, L=prob.L)
    first = next(resume_iterator(it_f32, st, rebase=True))
    np.testing.assert_allclose(
        np.asarray(first.av), np.asarray(F.apply_all(st.s)) / N,
        rtol=1e-10, atol=1e-12,
    )
    final = loop(take(resume_iterator(it_f32, st, rebase=True), 3500))
    assert prob.cost(np.asarray(final.z)) - prob.f_star < 1e-4

    # Finito coeff family: sharded rebase identity
    fsolver = DPFinito(mesh=mesh, maxit=2000, batch=16, sweeping=2,
                       table="coeff", seed=3)
    fst = loop(take(iter(fsolver.iterator(x0(prob), F=Fq, g=g, L=prob.L)), 200))
    f_it = fsolver.iterator(x0(prob), F=F, g=g, L=prob.L)
    ffirst = next(resume_iterator(f_it, fst, rebase=True))
    hat = np.asarray(fst.hat_gamma)
    av_ref = hat * (
        np.asarray(fst.invg) @ np.asarray(fst.zb)
        - np.asarray(F.apply_all(fst.c)) / N
    )
    np.testing.assert_allclose(np.asarray(ffirst.av), av_ref,
                               rtol=1e-10, atol=1e-12)


def test_tp_rebase_and_int8_storage():
    """int8 rows on the 2-D ("data","model") mesh: the un-descaled
    margin is psum'd over "model" BEFORE the per-row dequant scale is
    applied (coeff_from_margin), so the int8 TP trajectory must agree
    with the single-chip int8 one; resume with ``rebase=True`` must
    restore the av/table identity under new rows."""
    from ciao_tpu.checkpoint import resume_iterator
    from ciao_tpu.parallel import TPSAGA, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS
    from ciao_tpu.solvers.base import loop, take

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    Fq_host = F.with_storage("int8")
    Fq = shard_finite_sum_2d(Fq_host, mesh2)
    assert Fq.A.dtype == jnp.int8
    assert Fq.row_scale.sharding.spec == P(DATA_AXIS)
    g = NormL1(lam=jnp.asarray(prob.lam))

    # TP int8 trajectory == single-chip int8 trajectory (same schedule:
    # cyclic per-row blocks with D=1 data rows is the degenerate check;
    # with D=4 compare convergence instead)
    solver = TPSAGA(mesh=mesh2, maxit=3000, batch=4)
    xq, _ = solver(x0(prob), F=Fq, g=g, L=prob.L)
    assert prob.cost(np.asarray(xq)) - prob.f_star < 1e-3

    # rebase: run int8, resume under f32, av must equal apply_all(s)/N
    Ff = shard_finite_sum_2d(F, mesh2)
    st = loop(take(iter(solver.iterator(x0(prob), F=Fq, g=g, L=prob.L)), 200))
    it_f32 = solver.iterator(x0(prob), F=Ff, g=g, L=prob.L)
    first = next(resume_iterator(it_f32, st, rebase=True))
    np.testing.assert_allclose(
        np.asarray(first.av), np.asarray(F.apply_all(st.s)) / N,
        rtol=1e-10, atol=1e-12,
    )

    # TPFinito rebase identity
    from ciao_tpu.parallel import TPFinito

    fsolver = TPFinito(mesh=mesh2, maxit=2000, batch=4, sweeping=2)
    fst = loop(take(iter(fsolver.iterator(x0(prob), F=Fq, g=g, L=prob.L)), 100))
    f_it = fsolver.iterator(x0(prob), F=Ff, g=g, L=prob.L)
    ffirst = next(resume_iterator(f_it, fst, rebase=True))
    hat = np.asarray(fst.hat_gamma)
    av_ref = hat * (
        np.asarray(fst.invg) @ np.asarray(fst.zb)
        - np.asarray(F.apply_all(fst.c)) / N
    )
    np.testing.assert_allclose(np.asarray(ffirst.av), av_ref,
                               rtol=1e-10, atol=1e-12)


def test_dp_saga_local_steps(mesh, lasso):
    """Local-update DP SAGA (``local_steps=K``, beyond the reference —
    the multi-chip throughput mode): K purely-local steps per round,
    one collective at the round boundary. Pins (a) convergence to the
    reference tolerance on the planted problem, (b) the EXACT
    table-mean sync invariant av = Σ c_i·a_i/N after every round, and
    (c) determinism."""
    prob, F, g = lasso
    solver = DPSAGA(mesh=mesh, maxit=2000, batch=16, block_sampling=True,
                    local_steps=4, seed=3)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4

    from ciao_tpu.solvers.base import loop, take

    it = solver.iterator(x0(prob), F=F, g=g, L=prob.L)
    st = loop(take(iter(it), 7))
    # one iterate = one round of K local steps
    assert int(st.it) == 1 + 6 * 4
    np.testing.assert_allclose(
        np.asarray(st.av), np.asarray(F.apply_all(st.s)) / N,
        rtol=1e-10, atol=1e-12,
    )
    x2, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(x2))

    # misconfiguration: local rounds need the coefficient fast path
    with pytest.raises(ValueError, match="local_steps"):
        DPSAGA(mesh=mesh, maxit=10, batch=16, local_steps=4)(
            x0(prob), F=F, g=g, L=prob.L
        )


def test_dp_finito_local_steps(mesh, lasso):
    """Local-update DP Finito (``local_steps=K``, beyond the reference):
    K purely-local coefficient steps per round, one EXACT av resync at
    the round boundary. Pins (a) convergence at the reference tolerance,
    (b) the exact av invariant av = hat·(Σ invg_j·zb_j − Σ c_i·a_i/N)
    after every round, (c) z = prox(av), (d) determinism, and (e) the
    coefficient-mode requirement."""
    prob, F, g = lasso
    solver = DPFinito(mesh=mesh, maxit=2000, batch=16, sweeping=2,
                      local_steps=4, seed=3)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4

    from ciao_tpu.solvers.base import loop, take

    it = solver.iterator(x0(prob), F=F, g=g, L=prob.L)
    st = loop(take(iter(it), 7))
    # one iterate = one round of K local steps
    assert int(st.it) == 1 + 6 * 4
    hat = np.asarray(st.hat_gamma)
    av_ref = hat * (
        np.asarray(st.invg) @ np.asarray(st.zb)
        - np.asarray(F.apply_all(st.c)) / N
    )
    np.testing.assert_allclose(np.asarray(st.av), av_ref,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(st.z),
        np.asarray(g.prox_only(jnp.asarray(av_ref), st.hat_gamma)),
        rtol=1e-10, atol=1e-12,
    )
    x2, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(x2))

    # misconfiguration: local rounds need coefficient mode (rank-1
    # oracle + cyclic/shuffled sweeping + non-LFinito)
    with pytest.raises(ValueError, match="local_steps"):
        DPFinito(mesh=mesh, maxit=10, batch=16, sweeping=1,
                 local_steps=4)(x0(prob), F=F, g=g, L=prob.L)


def test_dp_finito_local_f32_periodic_rebase(mesh):
    """f32 drift regression: the local-round delta resync accumulates
    f32 rounding with no restoring force (measured: unrebased local
    Finito DIVERGES on this problem — suboptimality 1.4 after 3000
    rounds); the default periodic exact recompute
    (``rebase_every=50``) must hold the run below the reference
    tolerance."""
    Np, npix = 512, 32
    prob = make_lasso(N=Np, n=npix, p=4, seed=0, dtype=np.float32,
                      well_conditioned=True)
    F32 = LeastSquaresRows(
        A=jnp.asarray(prob.A, jnp.float32), b=jnp.asarray(prob.b, jnp.float32),
        scale=jnp.asarray(float(Np), jnp.float32),
    )
    F32 = shard_finite_sum(F32, mesh)
    g32 = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    z0 = jnp.zeros(npix, jnp.float32)
    x, _ = DPFinito(mesh=mesh, maxit=3000, batch=32, sweeping=3,
                    local_steps=8, seed=1)(z0, F=F32, g=g32, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_lfinito_local_sweep(mesh, lasso):
    """Local-sweep DP LFinito (``local_sweep=True``, beyond the
    reference): each device sweeps ONLY its own blocks against a
    private av copy; the epoch pays two collectives (anchor-refresh
    psum + delta resync) instead of one per block. Must still reach the
    reference tolerance on the planted lasso."""
    prob, F, g = lasso
    solver = DPFinito(mesh=mesh, LFinito=True, local_sweep=True,
                      maxit=200, batch=8, sweeping=3)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4

    # misconfiguration: the epoch-sweep mode is LFinito-only
    with pytest.raises(ValueError, match="local_sweep"):
        DPFinito(mesh=mesh, local_sweep=True, maxit=10, batch=8)(
            x0(prob), F=F, g=g, L=prob.L
        )


def test_dp_svrg_local_inner(mesh, lasso):
    """Local-inner DP SVRG (``local_inner=True``, beyond the
    reference): the whole m-step inner loop runs on-shard; only the
    outer boundary pays collectives (iterate-average psum + anchor
    psum). Must reach the reference tolerance, including SVRG++'s
    growing inner loop."""
    prob, F, g = lasso
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    x, _ = DPSVRG(mesh=mesh, maxit=500, batch=8, m=N, gamma=gamma,
                  local_inner=True)(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4

    # SVRG++: the locally-drifted inner averages slow each round ~2x
    # vs lockstep (no plateau — measured 1.3e-3 @ 16, 7.2e-5 @ 20
    # outer rounds), so the budget is 20 of the 25-round cap
    x, _ = DPSVRG(mesh=mesh, maxit=20, batch=8, m=8, plus=True,
                  local_inner=True)(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_svrg_local_inner_matches_lockstep_at_one_device():
    """At D=1 the local-inner and lockstep paths are the SAME
    algorithm (the psum'd direction equals the local one), and the
    stateless (key, it, k, device) draw streams coincide — the two
    modes must produce bit-equal trajectories on a 1-device mesh."""
    prob = make_lasso(N=32, n=8, p=3, seed=7)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(32.0),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    mesh1 = make_mesh(n_data=1, devices=jax.devices()[:1])
    F1 = shard_finite_sum(F, mesh1)
    z0 = jnp.zeros(8, prob.A.dtype)
    xs = []
    for li in (False, True):
        x, _ = DPSVRG(mesh=mesh1, maxit=5, batch=4, m=16,
                      local_inner=li)(z0, F=F1, g=g, L=prob.L)
        xs.append(np.asarray(x))
    np.testing.assert_array_equal(xs[0], xs[1])


def test_dp_svrg_plus_local_inner_matches_lockstep_at_one_device():
    """At D=1 the SVRG++ local-inner path must equal the lockstep path
    bit-for-bit, doubling m in sync."""
    prob = make_lasso(N=64, n=8, p=3, seed=7)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(64.0),
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    mesh1 = make_mesh(n_data=1, devices=jax.devices()[:1])
    F1 = shard_finite_sum(F, mesh1)
    z0 = jnp.zeros(8, prob.A.dtype)
    xs = []
    for li in (False, True):
        x, _ = DPSVRG(mesh=mesh1, maxit=5, batch=4, m=8, plus=True,
                      local_inner=li)(z0, F=F1, g=g, L=prob.L)
        xs.append(np.asarray(x))
    np.testing.assert_array_equal(xs[0], xs[1])


def test_tp_lfinito_converges_and_shards():
    """TPLFinito on a (4 data x 2 model) mesh: O(n) memory (no table),
    iterate/average/anchor sharded by coordinate, stepsizes by sample;
    converges at the reference tolerance for cyclic and shuffled
    sweeps."""
    from ciao_tpu.parallel import TPLFinito, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum_2d(F, mesh2)
    g = NormL1(lam=jnp.asarray(prob.lam))
    for sweeping in (2, 3):
        solver = TPLFinito(mesh=mesh2, maxit=200, batch=4, sweeping=sweeping)
        x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4, sweeping
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.z.sharding.spec == P(MODEL_AXIS)
    assert st.av.sharding.spec == P(MODEL_AXIS)
    assert st.gamma.sharding.spec == P(DATA_AXIS)

    # separable-prox guard (coordinates are sharded)
    from ciao_tpu.prox import NormL2

    with pytest.raises(ValueError, match="separable"):
        TPLFinito(mesh=mesh2)(
            x0(prob), F=F, g=NormL2(lam=jnp.asarray(1.0)), L=prob.L
        )


def test_tp_svrg_converges_and_shards():
    """TPSVRG/SVRG++ on a (4 data x 2 model) mesh: anchor coefficients
    recomputed once per outer step, inner steps pay one (B,)-margin
    "model" psum + one x-shard "data" psum; converges at the reference
    budgets (SVRG++ with growing m under the 25-iterate cap)."""
    from ciao_tpu.parallel import TPSVRG, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum_2d(F, mesh2)
    g = NormL1(lam=jnp.asarray(prob.lam))
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    solver = TPSVRG(mesh=mesh2, maxit=500, batch=4, m=N, gamma=gamma)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.z_full.sharding.spec == P(MODEL_AXIS)
    assert st.av.sharding.spec == P(MODEL_AXIS)

    x, _ = TPSVRG(mesh=mesh2, maxit=16, batch=4, m=2, plus=True)(
        x0(prob), F=F, g=g, L=prob.L
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_proshi_local_steps(mesh, sharing):
    """Local-update DP ProShI (``local_steps=K``, beyond the
    reference): K contiguous-block updates per round against a stale
    locally-maintained coupling, one exact Σ s_i resync per round.
    Must reach the same coupling target as the lockstep DP path."""
    F, g, L, Nb, nb, sum_ref = sharing
    solver = DPProshi(mesh=mesh, maxit=4000, batch=8, local_steps=4,
                      sweeping=2)
    x, _ = solver(jnp.zeros(nb), F=F, g=g, L=jnp.asarray(L), N=Nb)
    assert x.shape == (Nb, nb)
    got = np.asarray(jnp.sum(x, axis=0))
    np.testing.assert_allclose(got, sum_ref, atol=2e-2)
    assert np.all(got <= 1.0 + 1e-6)

    # one iterate = one round of K local steps (init is iteration 1)
    from ciao_tpu.solvers.base import loop, take

    it = solver.iterator(jnp.zeros(nb), F=F, g=g, L=jnp.asarray(L), N=Nb)
    st = loop(take(iter(it), 3))
    assert int(st.it) == 1 + 2 * 4
    # round-boundary invariant: av is the exact global block sum
    np.testing.assert_allclose(
        np.asarray(st.av), np.asarray(jnp.sum(st.s, axis=0)),
        rtol=1e-8, atol=1e-10,
    )


def test_dp_complex_dtype(mesh):
    """Complex support under DP (the reference's dtype sweep,
    test_lasso.jl:3, which no sharded path may lose): c128 lasso
    converges at the reference tolerance and keeps the dtype."""
    prob = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    F = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh,
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(n, prob.A.dtype)
    x, _ = DPFinito(mesh=mesh, maxit=2000, batch=8, sweeping=2)(
        z0, F=F, g=g, L=prob.L
    )
    assert x.dtype == prob.A.dtype
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    x, _ = DPSVRG(mesh=mesh, maxit=300, batch=8, m=N, local_inner=True,
                  gamma=1.0 / (7 * float(np.max(prob.L))))(
        z0, F=F, g=g, L=prob.L
    )
    assert x.dtype == prob.A.dtype
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_proshi_local_rejects_nondividing_batch(mesh, sharing):
    """Local ProShI rounds sample contiguous blocks only — a batch that
    does not divide the shard would silently never touch the tail rows
    (reviewed bug); the facade must reject it."""
    F, g, L, Nb, nb, _ = sharing
    # Nb=24 over D=8 gives n_loc=3; batch=16 -> b_loc=2 does not divide
    with pytest.raises(ValueError, match="divisible"):
        DPProshi(mesh=mesh, maxit=10, batch=16, local_steps=4)(
            jnp.zeros(nb), F=F, g=g, L=jnp.asarray(L), N=Nb
        )


def test_dp_svrg_lockstep_block_sampling(mesh, lasso):
    """block_sampling=True must engage the contiguous-block draw on the
    LOCKSTEP path too (reviewed bug: the knob was silently ignored):
    the trajectory differs from the gather path and still converges."""
    prob, F, g = lasso
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    xs = {}
    for blk in (False, True):
        x, _ = DPSVRG(mesh=mesh, maxit=500, batch=8, m=N, gamma=gamma,
                      block_sampling=blk)(x0(prob), F=F, g=g, L=prob.L)
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
        # different sampling streams -> different EARLY trajectories
        # (at convergence both snap to the same prox fixed point)
        xe, _ = DPSVRG(mesh=mesh, maxit=3, batch=8, m=N, gamma=gamma,
                       block_sampling=blk)(x0(prob), F=F, g=g, L=prob.L)
        xs[blk] = np.asarray(xe)
    assert not np.array_equal(xs[False], xs[True])


def test_dp_katyusha_converges_and_local_inner(mesh, lasso):
    """DP Katyusha (beyond the reference): lockstep (pmean'd direction
    per inner step) and local-inner (two collectives per outer step)
    both reach the reference tolerance; at D=1 the modes are bit-equal
    (same stateless streams, psum degenerates)."""
    from ciao_tpu.parallel import DPKatyusha

    prob, F, g = lasso
    for li in (False, True):
        x, _ = DPKatyusha(mesh=mesh, maxit=60, batch=8, local_inner=li)(
            x0(prob), F=F, g=g, L=prob.L
        )
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4, li

    x, _ = DPKatyusha(mesh=mesh, maxit=60, batch=8, sigma=1.0,
                      block_sampling=True)(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4

    mesh1 = make_mesh(n_data=1, devices=jax.devices()[:1])
    F1 = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh1,
    )
    outs = []
    for li in (False, True):
        xe, _ = DPKatyusha(mesh=mesh1, maxit=5, batch=4, local_inner=li)(
            x0(prob), F=F1, g=g, L=prob.L
        )
        outs.append(np.asarray(xe))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_dp_sarah_converges_and_local_inner(mesh, lasso):
    """DP SARAH (beyond the reference — recursive variance reduction):
    lockstep (pmean'd innovation per inner step) and local-inner (two
    collectives per outer step) both reach the reference tolerance; at
    D=1 the modes are bit-equal (same stateless streams, psum
    degenerates)."""
    from ciao_tpu.parallel import DPSARAH

    prob, F, g = lasso
    for li in (False, True):
        x, _ = DPSARAH(mesh=mesh, maxit=30, batch=8, m=N, local_inner=li)(
            x0(prob), F=F, g=g, L=prob.L
        )
        assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4, li

    x, _ = DPSARAH(mesh=mesh, maxit=30, batch=8, m=N, eta=0.8,
                   block_sampling=True)(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4

    mesh1 = make_mesh(n_data=1, devices=jax.devices()[:1])
    F1 = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh1,
    )
    outs = []
    for li in (False, True):
        xe, _ = DPSARAH(mesh=mesh1, maxit=5, batch=4, local_inner=li)(
            x0(prob), F=F1, g=g, L=prob.L
        )
        outs.append(np.asarray(xe))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_tp_sarah_converges_and_shards():
    """TPSARAH on a (4 data x 2 model) mesh: the moving reference point
    makes each inner step pay a stacked (2,B)-margin "model" psum (at
    w_t AND w_{t−1}) + one x-shard "data" psum; the iterate stays
    coordinate-sharded. Non-separable prox rejected."""
    from ciao_tpu.parallel import TPSARAH, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS
    from ciao_tpu.prox import NormL2

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    Fd = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum_2d(Fd, mesh2)
    g = NormL1(lam=jnp.asarray(prob.lam))
    solver = TPSARAH(mesh=mesh2, maxit=30, batch=4, m=N)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.x_tilde.sharding.spec == P(MODEL_AXIS)
    # init does no gradient work: solution(init) == x0
    np.testing.assert_allclose(np.asarray(st.solution), 0.0)
    with pytest.raises(ValueError, match="separable"):
        TPSARAH(mesh=mesh2)(
            x0(prob), F=Fd, g=NormL2(lam=jnp.asarray(1.0)), L=prob.L
        )


def test_dp_huber_oracle(mesh):
    """HuberRows under DP: the sharded paths (grad_sum_diff, coeff
    tables, psums) serve the robust-regression oracle; DP SAGA and DP
    Katyusha agree on the fixed point."""
    from ciao_tpu.oracles import HuberRows
    from ciao_tpu.parallel import DPKatyusha

    rng = np.random.default_rng(7)
    Np, npx = 64, 8
    A = rng.standard_normal((Np, npx))
    x_true = rng.standard_normal(npx)
    y = A @ x_true + 0.01 * rng.standard_normal(Np)
    y[rng.choice(Np, 6, replace=False)] += 30.0
    F = shard_finite_sum(
        HuberRows(A=jnp.asarray(A), b=jnp.asarray(y),
                  delta=jnp.asarray(0.5), scale=jnp.asarray(float(Np))),
        mesh,
    )
    L = float(Np) * (A * A).sum(axis=1)
    z0 = jnp.zeros(npx)
    xs, _ = DPSAGA(mesh=mesh, maxit=30000, batch=8)(z0, F=F, L=L)
    xk, _ = DPKatyusha(mesh=mesh, maxit=120, batch=8)(z0, F=F, L=L)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xk), atol=1e-4)
    assert np.linalg.norm(np.asarray(xk) - x_true) < 0.1


def test_tp_katyusha_converges_and_shards():
    """TPKatyusha on a (4 data x 2 model) mesh (beyond the reference —
    accelerated variance reduction on the TPSVRG data path): anchor
    coefficients recomputed once per outer step, inner steps pay one
    (B,)-margin "model" psum + one x-shard "data" psum; the three
    momentum sequences stay coordinate-sharded."""
    from ciao_tpu.parallel import TPKatyusha, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum_2d(F, mesh2)
    g = NormL1(lam=jnp.asarray(prob.lam))
    solver = TPKatyusha(mesh=mesh2, maxit=300, batch=4)
    x, _ = solver(x0(prob), F=F, g=g, L=prob.L)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    st = next(iter(solver.iterator(x0(prob), F=F, g=g, L=prob.L)))
    assert st.x_tilde.sharding.spec == P(MODEL_AXIS)
    assert st.av.sharding.spec == P(MODEL_AXIS)
    assert st.y.sharding.spec == P(MODEL_AXIS)
    # init state is iteration #1: solution(init) == x0 (SVRG convention)
    np.testing.assert_allclose(np.asarray(st.solution), 0.0)


def test_tp_katyusha_rejects_nonseparable_prox():
    from ciao_tpu.parallel import TPKatyusha, make_mesh_2d
    from ciao_tpu.prox import NormL2

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    with pytest.raises(ValueError, match="separable"):
        TPKatyusha(mesh=mesh2)(
            x0(prob), F=F, g=NormL2(lam=jnp.asarray(1.0)), L=prob.L
        )


def test_dp_finito_adaptive_converges_and_shards(mesh, lasso):
    """DP adaptive Finito (reference Finito_adaptive.jl over the mesh —
    SURVEY.md §7's hardest-to-distribute variant): the three N-tables
    shard by index block, the global single index's owner broadcasts
    its row state in one stacked psum, and the backtracking loop runs
    lockstep with one scalar psum per backtrack iteration."""
    prob, F, g = lasso
    solver = DPFinito(mesh=mesh, adaptive=True, sweeping=2, maxit=8000)
    x, _ = solver(x0(prob), F=F, g=g)
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4

    st = next(iter(solver.iterator(x0(prob), F=F, g=g)))
    assert st.s.sharding.spec == P(DATA_AXIS, None)
    assert st.gradf.sharding.spec == P(DATA_AXIS, None)
    assert st.fi_x.sharding.spec == P(DATA_AXIS)
    assert st.gamma.sharding.spec == P(DATA_AXIS)
    # stepsizes come from the probe, not from L (which is never passed)
    assert np.all(np.asarray(st.gamma) > 0)


def test_dp_finito_adaptive_matches_single_chip_cyclic(mesh, lasso):
    """Under cyclic sweeping the DP-adaptive index stream equals the
    single-chip one (0,1,2,...), the probe is deterministic, and the
    backtracking algebra is identical — trajectories agree to fp
    reduction-order noise."""
    prob, F, g = lasso
    x_dp, _ = DPFinito(mesh=mesh, adaptive=True, sweeping=2, maxit=500)(
        x0(prob), F=F, g=g
    )
    F1 = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    x_sc, _ = ciao_tpu.Finito(adaptive=True, sweeping=2, maxit=500)(
        x0(prob), F=F1, g=g, N=N
    )
    np.testing.assert_allclose(
        np.asarray(x_dp), np.asarray(x_sc), rtol=0, atol=1e-10
    )


def test_dp_finito_adaptive_validates(mesh, lasso):
    prob, F, g = lasso
    with pytest.raises(ValueError, match="exclusive"):
        DPFinito(mesh=mesh, adaptive=True, LFinito=True)(x0(prob), F=F, g=g)
    with pytest.raises(ValueError, match="single-index"):
        DPFinito(mesh=mesh, adaptive=True, batch=8)(x0(prob), F=F, g=g)


# ---------------------------------------------------------------------------
# tensor-parallel ProShI (sharing formulation, coordinate-separable oracles)
# ---------------------------------------------------------------------------

def _sharing_24():
    """The DP fixture's 24-block sharing problem, unsharded (the
    reference's 3 blocks replicated 8x, test_sharing.jl:13-24)."""
    reps = 8
    base_d = np.array([[1.0, 2.0], [-1.0, 3.0], [0.0, 10.0]])
    d = np.tile(base_d, (reps, 1))
    q = np.ones_like(d)
    Nb, nb = d.shape
    eta = Nb * 10.0
    L = np.abs(d).max(axis=1) + eta
    F = SumOracle(
        terms=(
            DiagQuadratic(d=jnp.asarray(d), q=jnp.asarray(q)),
            SqrDistBox(
                lo=jnp.asarray(-2.0), hi=jnp.asarray(2.0),
                eta=jnp.asarray(eta), n_terms=Nb,
            ),
        )
    )
    g = IndBox(lo=-jnp.inf, hi=jnp.asarray(np.ones(nb)))
    return F, g, jnp.asarray(L), Nb, nb


def test_tp_proshi_matches_dp_and_shards():
    """TPProshi on a (4 data x 2 model) mesh: the block table shards
    over BOTH axes and — because the sharing oracles are coordinate-
    separable and the index schedule folds only the data axis — the
    trajectory equals DPProshi on the same 4-device data axis exactly."""
    from ciao_tpu.parallel import TPProshi, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.parallel.mesh import MODEL_AXIS

    F, g, L, Nb, nb = _sharing_24()
    mesh2 = make_mesh_2d(4, 2)
    F2 = shard_finite_sum_2d(F, mesh2, N=Nb)
    solver = TPProshi(mesh=mesh2, maxit=10000, batch=8, sweeping=2)
    x, it = solver(jnp.zeros(nb), F=F2, g=g, L=L, N=Nb)
    assert x.shape == (Nb, nb)
    got = np.asarray(jnp.sum(x, axis=0))
    assert np.all(got <= 1.0 + 1e-6)  # the coupling constraint holds

    mesh = make_mesh(4, devices=jax.devices()[:4])
    Fd = shard_finite_sum(F, mesh, N=Nb)
    xd, _ = DPProshi(mesh=mesh, maxit=10000, batch=8, sweeping=2)(
        jnp.zeros(nb), F=Fd, g=g, L=L, N=Nb
    )
    np.testing.assert_allclose(np.asarray(x), np.asarray(xd),
                               rtol=1e-12, atol=1e-12)

    st = next(iter(solver.iterator(jnp.zeros(nb), F=F2, g=g, L=L, N=Nb)))
    assert st.s.sharding.spec == P(DATA_AXIS, MODEL_AXIS)
    assert st.gamma.sharding.spec == P(DATA_AXIS)
    assert st.av.sharding.spec == P(MODEL_AXIS)
    assert st.z.sharding.spec == P(MODEL_AXIS)
    # round-trip invariant: av is the exact global block sum at init
    np.testing.assert_allclose(
        np.asarray(st.av), np.asarray(jnp.sum(st.s, axis=0)),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("sweeping", [1, 3])
def test_tp_proshi_random_and_shuffled_converge(sweeping):
    from ciao_tpu.parallel import TPProshi, make_mesh_2d, shard_finite_sum_2d

    F, g, L, Nb, nb = _sharing_24()
    mesh2 = make_mesh_2d(4, 2)
    F2 = shard_finite_sum_2d(F, mesh2, N=Nb)
    x, _ = TPProshi(mesh=mesh2, maxit=10000, batch=8, sweeping=sweeping)(
        jnp.zeros(nb), F=F2, g=g, L=L, N=Nb
    )
    x_cyc, _ = TPProshi(mesh=mesh2, maxit=10000, batch=8, sweeping=2)(
        jnp.zeros(nb), F=F2, g=g, L=L, N=Nb
    )
    np.testing.assert_allclose(
        np.asarray(jnp.sum(x, axis=0)), np.asarray(jnp.sum(x_cyc, axis=0)),
        atol=2e-2,
    )


def test_tp_proshi_validates():
    from ciao_tpu.parallel import TPProshi, make_mesh_2d
    from ciao_tpu.prox import NormL2

    F, g, L, Nb, nb = _sharing_24()
    mesh2 = make_mesh_2d(4, 2)
    with pytest.raises(ValueError, match="separable"):
        TPProshi(mesh=mesh2)(jnp.zeros(nb), F=F, g=NormL2(lam=jnp.asarray(1.0)),
                             L=L, N=Nb)
    # row oracles (gradient needs the full a_i·x dot) must be rejected
    prob = make_lasso(N=Nb, n=nb, p=1, seed=0)
    F_rows = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(Nb)),
    )
    with pytest.raises(ValueError, match="coordinate-separable"):
        TPProshi(mesh=mesh2)(jnp.zeros(nb), F=F_rows, g=g, L=L, N=Nb)


def test_tp_vector_prox_params():
    """Per-coordinate prox parameters must shard over "model" with the
    iterate (model_prox_specs): a vector-lam L1 on TPSAGA agrees with
    the same run under a scalar lam of equal value."""
    from ciao_tpu.parallel import TPSAGA, make_mesh_2d, shard_finite_sum_2d

    mesh2 = make_mesh_2d(4, 2)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    F = shard_finite_sum_2d(F, mesh2)
    g_vec = NormL1(lam=jnp.full((n,), prob.lam))
    g_sc = NormL1(lam=jnp.asarray(prob.lam))
    xv, _ = TPSAGA(mesh=mesh2, maxit=500, batch=8)(x0(prob), F=F, g=g_vec, L=prob.L)
    xs, _ = TPSAGA(mesh=mesh2, maxit=500, batch=8)(x0(prob), F=F, g=g_sc, L=prob.L)
    np.testing.assert_allclose(np.asarray(xv), np.asarray(xs), rtol=1e-12, atol=1e-12)


def test_tp_rejects_sparse_ell_oracles():
    """Sparse ELL layouts carry GLOBAL column ids — a coordinate shard
    cannot evaluate its slots locally, so the TP facades must reject
    them with a clear error (before this guard the failure surfaced as
    a confusing device_put divisibility error, or — had K divided the
    model axis — silently wrong margins)."""
    from ciao_tpu.oracles import SparseLeastSquaresELL
    from ciao_tpu.parallel import TPSAGA, TPKatyusha, make_mesh_2d

    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, n))
    A[np.abs(A) < 1.2] = 0
    b = rng.standard_normal(N)
    Fs = SparseLeastSquaresELL.from_dense(A, b, float(N))
    L = (A ** 2).sum(axis=1) * N
    mesh2 = make_mesh_2d(4, 2)
    g = NormL1(lam=jnp.asarray(0.1))
    with pytest.raises(ValueError, match="DP-only"):
        TPSAGA(mesh=mesh2, batch=4)(jnp.zeros(n), F=Fs, g=g, L=L)
    with pytest.raises(ValueError, match="DP-only"):
        TPKatyusha(mesh=mesh2, batch=4)(jnp.zeros(n), F=Fs, g=g, L=L)


def test_tp_complex_dtype():
    """Complex support under TP (the reference's dtype sweep,
    test_lasso.jl:3): the coordinate-sharded margins/coefficients keep
    c128 and converge at the reference tolerance."""
    from ciao_tpu.parallel import TPSAGA, make_mesh_2d, shard_finite_sum_2d

    prob = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    mesh2 = make_mesh_2d(4, 2)
    F = shard_finite_sum_2d(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh2,
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(n, prob.A.dtype)
    x, _ = TPSAGA(mesh=mesh2, maxit=3000, batch=8)(z0, F=F, g=g, L=prob.L)
    assert x.dtype == prob.A.dtype
    assert float(np.real(prob.cost(np.asarray(x)) - prob.f_star)) < 1e-4


def test_sharded_checkpoint_resume_bit_exact(mesh, lasso, tmp_path):
    """orbax async save of a DP-SHARDED SAGA state (the (N, n) gradient
    table laid out over the 8-device data axis), restore with the same
    shardings, resume — bit-exact vs the straight-through run, and the
    restored table is actually sharded, not gathered to one device
    (SURVEY §5 checkpoint row: per-shard async)."""
    from ciao_tpu import checkpoint

    prob, F, g = lasso
    solver = DPSAGA(mesh=mesh, batch=8, seed=11)
    it_stream = solver.iterator(x0(prob), F=F, g=g, L=prob.L)
    stream = iter(it_stream)
    state = next(stream)
    for _ in range(5):
        state = next(stream)
    assert state.s.sharding.spec == P(DATA_AXIS, None)

    mgr = checkpoint.save_async(tmp_path / "dpck", state)
    mgr.wait_until_finished()
    restored = checkpoint.load_orbax(tmp_path / "dpck", state)
    # per-shard layout round-trips: the table comes back SHARDED over
    # the data axis with identical bits
    assert restored.s.sharding.spec == P(DATA_AXIS, None)
    np.testing.assert_array_equal(np.asarray(restored.s), np.asarray(state.s))
    np.testing.assert_array_equal(np.asarray(restored.key), np.asarray(state.key))

    # resume the restored state and the live state 10 further steps
    # each: identical trajectories (stateless schedules + same bits)
    from ciao_tpu.checkpoint import resume_iterator

    res = resume_iterator(it_stream, restored)
    assert np.array_equal(np.asarray(next(res).z), np.asarray(state.z))
    cont_live, cont_res = state, restored
    for _ in range(10):
        cont_live = it_stream._step_fn(cont_live)
        cont_res = next(res)
    np.testing.assert_array_equal(np.asarray(cont_res.z),
                                  np.asarray(cont_live.z))
    np.testing.assert_array_equal(np.asarray(cont_res.s),
                                  np.asarray(cont_live.s))
    assert cont_res.s.sharding.spec == P(DATA_AXIS, None)


def test_dp_adaptive_gamma_underflow_abort_characterized(mesh, lasso):
    """Characterizes the γ-underflow abort AT the fixed point (VERDICT
    round-1 weak #3): once adaptive Finito reaches machine-precision
    optimality, the backtracking acceptance f_i(z) ≤ model + 10·eps·
    (1+|f_i(z)|) — the REFERENCE's own tolerance, Finito_adaptive.jl:133
    — is roundoff-dominated, γ_i shrinks without bound, and the solver
    aborts with the reference's @warn (Finito_adaptive.jl:123-125).
    This is intended parity, not a defect: both the single-chip and the
    DP run abort BEFORE maxit at a machine-precision solution. The
    abort STEP differs between them (measured 5982 vs 5187 on this
    fixture) — ~5k steps of psum reduction-order noise flip
    roundoff-dominated backtrack decisions — so the pin is on the
    behavior, not the index."""
    import warnings as _warnings

    prob, F, g = lasso
    F1 = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
        scale=jnp.asarray(float(N)),
    )
    with _warnings.catch_warnings(record=True) as w1:
        _warnings.simplefilter("always")
        x1, it1 = ciao_tpu.Finito(adaptive=True, sweeping=2, maxit=8000)(
            x0(prob), F=F1, g=g
        )
    with _warnings.catch_warnings(record=True) as w2:
        _warnings.simplefilter("always")
        x2, it2 = DPFinito(mesh=mesh, adaptive=True, sweeping=2, maxit=8000)(
            x0(prob), F=F, g=g
        )
    for w, it in ((w1, it1), (w2, it2)):
        assert any("too small" in str(m.message) for m in w)
        assert it < 8000  # aborted, did not exhaust the budget
    # the abort fires AT the optimum: machine-precision suboptimality
    assert prob.cost(np.asarray(x1)) - prob.f_star < 1e-10
    assert prob.cost(np.asarray(x2)) - prob.f_star < 1e-10


def _kernel_sized_dp_problem(mesh):
    Np, npix = 8192, 128
    prob = make_lasso(N=Np, n=npix, p=4, seed=5, dtype=np.float32,
                      well_conditioned=True)
    F = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A, jnp.float32),
            b=jnp.asarray(prob.b, jnp.float32),
            scale=jnp.asarray(float(Np), jnp.float32),
        ),
        mesh,
    )
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    return prob, F, g, Np, npix


def test_dp_adaptive_iterator_terminates_on_abort(mesh):
    """Regression (round-2 review): SolverIterable only pays the
    per-step status readback when can_abort=True — the DP facade must
    pass it for adaptive Finito, or the stream yields the frozen
    aborted state forever."""
    from ciao_tpu.solvers.base import take

    prob = make_lasso(N=64, n=8, p=3, seed=1)
    F = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A * 1e8), b=jnp.asarray(prob.b),
            scale=jnp.asarray(64.0),
        ),
        mesh,
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    solver = DPFinito(mesh=mesh, adaptive=True, sweeping=2, tol_b=1e30)
    states = list(take(iter(solver.iterator(jnp.zeros(8), F=F, g=g)), 500))
    # the γ-underflow abort must terminate the stream well before 500
    assert len(states) < 500


def test_elastic_restore_onto_smaller_mesh(mesh, lasso, tmp_path):
    """ELASTIC recovery (SURVEY §5 failure-recovery row, production
    form): a DP-sharded state checkpointed on the 8-device mesh is
    restored onto a 4-DEVICE mesh — orbax reshards the global (N, ...)
    tables to the new layout given a target-mesh state template — and
    the solve RESUMES to the planted optimum. The trajectory after the
    shrink legitimately differs (the stateless schedules are functions
    of the mesh layout) but the state is global and algorithmically
    valid on any mesh the problem divides over."""
    from ciao_tpu import checkpoint
    from ciao_tpu.parallel import make_mesh

    prob, F, g = lasso
    solver8 = DPSAGA(mesh=mesh, batch=8, seed=11)
    stream8 = iter(solver8.iterator(x0(prob), F=F, g=g, L=prob.L))
    state8 = next(stream8)
    for _ in range(200):
        state8 = next(stream8)
    mgr = checkpoint.save_async(tmp_path / "elastic", state8)
    mgr.wait_until_finished()

    # the 4-device survivor mesh: re-shard the oracle, build a state
    # template with the NEW shardings, restore into it
    mesh4 = make_mesh(n_data=4, devices=jax.devices()[:4])
    F4 = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh4,
    )
    solver4 = DPSAGA(mesh=mesh4, batch=8, seed=11, maxit=4000)
    it4 = solver4.iterator(x0(prob), F=F4, g=g, L=prob.L)
    template = next(iter(it4))
    restored = checkpoint.load_orbax(tmp_path / "elastic", template)
    # bits survived the reshard; layout is the survivor mesh's
    np.testing.assert_array_equal(np.asarray(restored.s),
                                  np.asarray(state8.s))
    assert restored.s.sharding.mesh.shape[DATA_AXIS] == 4
    assert restored.s.sharding.spec == P(DATA_AXIS, None)

    # resume on the smaller mesh and reach the reference tolerance
    # (periodic sync: unbounded async dispatch queues abort the CPU
    # runtime — the round-2 crash mechanism, see SolverIterable)
    state = restored
    for k in range(3000):
        state = it4._step_fn(state)
        if k % 16 == 0:
            jax.block_until_ready(state)
    gap = prob.cost(np.asarray(state.z)) - prob.f_star
    assert gap < 1e-4


def test_elastic_restore_onto_larger_mesh(mesh, lasso, tmp_path):
    """The GROW direction of elastic recovery: a state saved on a
    4-device mesh restores onto the full 8-device mesh and resumes
    (orbax reshards to the larger template's layout)."""
    from ciao_tpu import checkpoint
    from ciao_tpu.parallel import make_mesh

    prob, F8, g = lasso
    mesh4 = make_mesh(n_data=4, devices=jax.devices()[:4])
    F4 = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh4,
    )
    it4 = DPSAGA(mesh=mesh4, batch=8, seed=11).iterator(
        x0(prob), F=F4, g=g, L=prob.L
    )
    s4 = iter(it4)
    state = next(s4)
    for _ in range(100):
        state = next(s4)
    mgr = checkpoint.save_async(tmp_path / "grow", state)
    mgr.wait_until_finished()

    it8 = DPSAGA(mesh=mesh, batch=8, seed=11).iterator(
        x0(prob), F=F8, g=g, L=prob.L
    )
    template = next(iter(it8))
    restored = checkpoint.load_orbax(tmp_path / "grow", template)
    assert restored.s.sharding.mesh.shape[DATA_AXIS] == 8
    np.testing.assert_array_equal(np.asarray(restored.s),
                                  np.asarray(state.s))
    st = restored
    for k in range(3000):
        st = it8._step_fn(st)
        if k % 16 == 0:
            jax.block_until_ready(st)
    assert prob.cost(np.asarray(st.z)) - prob.f_star < 1e-4

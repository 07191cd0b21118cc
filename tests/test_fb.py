"""ForwardBackward (ISTA) / FISTA — deterministic full-gradient
baselines (beyond the reference; the ProximalAlgorithms.jl surface its
users compare against). Pins: reference tolerance on the planted
problems, the O(1/k²) acceleration gap, dtype preservation, and the
streaming-API invariants."""

import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import NormL1
from ciao_tpu.utils.problems import make_lasso

N, n = 64, 8


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    return prob, F, g


def x0(prob):
    return jnp.zeros(prob.A.shape[1], prob.A.dtype)


def test_fb_and_fista_converge(lasso):
    prob, F, g = lasso
    x, it = ciao_tpu.ForwardBackward(maxit=4000)(
        x0(prob), F=F, g=g, L=prob.L, N=N
    )
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4
    assert it == 4000
    xf, _ = ciao_tpu.FISTA(maxit=400)(x0(prob), F=F, g=g, L=prob.L, N=N)
    assert prob.cost(np.asarray(xf)) - prob.f_star < 1e-4


def test_fista_accelerates(lasso):
    """At a MATCHED budget of full-gradient steps, FISTA must land at
    least 10x closer to the optimum than ISTA (O(1/k²) vs O(1/k))."""
    prob, F, g = lasso
    k = 150
    xi, _ = ciao_tpu.ForwardBackward(maxit=k)(x0(prob), F=F, g=g, L=prob.L, N=N)
    xf, _ = ciao_tpu.FISTA(maxit=k)(x0(prob), F=F, g=g, L=prob.L, N=N)
    gap_i = prob.cost(np.asarray(xi)) - prob.f_star
    gap_f = prob.cost(np.asarray(xf)) - prob.f_star
    assert gap_f * 10 < gap_i, (gap_f, gap_i)


def test_fb_iterator_invariants_and_errors(lasso):
    from ciao_tpu.solvers.base import take

    prob, F, g = lasso
    solver = ciao_tpu.FISTA(maxit=5)
    it = solver.iterator(x0(prob), F=F, g=g, L=prob.L, N=N)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(np.asarray(states[0].solution),
                                  np.asarray(x0(prob)))
    x_batch, _ = solver(x0(prob), F=F, g=g, L=prob.L, N=N)
    np.testing.assert_array_equal(np.asarray(states[-1].solution),
                                  np.asarray(x_batch))
    with pytest.raises(ValueError, match="smoothness"):
        ciao_tpu.ForwardBackward(maxit=2)(x0(prob), F=F, g=g, N=N)


def test_fb_complex_dtype():
    prob = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    x, _ = ciao_tpu.FISTA(maxit=400)(jnp.zeros(n, prob.A.dtype), F=F, g=g,
                                     L=prob.L, N=N)
    assert x.dtype == prob.A.dtype
    assert prob.cost(np.asarray(x)) - prob.f_star < 1e-4


def test_dp_fista_matches_single_chip():
    """DPFISTA on the 8-device CPU mesh: deterministic method, so the
    trajectory must EQUAL the single-chip FISTA (one psum'd full
    gradient per step) to f64 reduction-order tolerance."""
    import jax
    from ciao_tpu.parallel import DPFISTA, make_mesh, shard_finite_sum

    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(n, prob.A.dtype)
    mesh = make_mesh()
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPFISTA(mesh=mesh, maxit=200)(z0, F=Fd, g=g, L=prob.L, N=N)
    x_sc, _ = ciao_tpu.FISTA(maxit=200)(z0, F=F, g=g, L=prob.L, N=N)
    np.testing.assert_allclose(np.asarray(x_dp), np.asarray(x_sc),
                               rtol=1e-9, atol=1e-12)
    assert prob.cost(np.asarray(x_dp)) - prob.f_star < 1e-4


def test_tp_fista_matches_single_chip():
    """TPFISTA on a (4 data x 2 model) mesh: deterministic method —
    the 2-D-sharded trajectory must equal the single-chip one."""
    from ciao_tpu.parallel import TPFISTA, make_mesh_2d, shard_finite_sum_2d
    from ciao_tpu.prox import NormL2

    prob = make_lasso(N=N, n=n, p=3, seed=3)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(float(N))
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    z0 = jnp.zeros(n, prob.A.dtype)
    mesh2 = make_mesh_2d(4, 2)
    F2 = shard_finite_sum_2d(F, mesh2)
    x_tp, _ = TPFISTA(mesh=mesh2, maxit=200)(z0, F=F2, g=g, L=prob.L, N=N)
    x_sc, _ = ciao_tpu.FISTA(maxit=200)(z0, F=F, g=g, L=prob.L, N=N)
    np.testing.assert_allclose(np.asarray(x_tp), np.asarray(x_sc),
                               rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="separable"):
        TPFISTA(mesh=mesh2)(z0, F=F, g=NormL2(lam=jnp.asarray(1.0)),
                            L=prob.L, N=N)


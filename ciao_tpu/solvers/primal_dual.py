"""Condat-Vũ primal-dual splitting — and Chambolle-Pock as its f = 0
special case (BEYOND the reference).

Solves the three-term composite with a LINEAR map inside the nonsmooth
term:

    minimize_x  (1/N) Σ_i f_i(x)  +  g(x)  +  h(Kx)

f smooth (the framework's finite-sum oracle), g and h proximable, K a
linear map (:mod:`ciao_tpu.ops.linmap`). This is the capability the
prox-of-g-only reference cannot express at all: total variation
(h = λ‖·‖₁, K = FirstDifference), analysis sparsity / fused lasso
(K = DenseMap), dual-ball constraints. Condat (JOTA 2013) / Vũ (ACM
2013); with f = 0 it reduces exactly to Chambolle-Pock (JMIV 2011).

Iteration, primal step τ, dual step σ:

    x⁺ = prox_{τg}(x − τ(∇f(x) + Kᵀy))
    u  = y + σ·K(2x⁺ − x)
    y⁺ = u − σ·prox_{h/σ}(u/σ)          (Moreau: prox_{σh*}(u))

Convergence requires  τ·(L_f/2 + σ‖K‖²) ≤ 1.  Defaults: σ = 1/‖K‖,
τ = 1/(L_f/2 + σ‖K‖²) with L_f = mean(L) (the full finite-sum's
modulus) and ‖K‖ from the map's ``opnorm_bound``.

Data path: the only O(N) work is the full gradient — the same ONE
pass as FB/FISTA/Davis-Yin (`solvers.fb.full_gradient`); K's
matvec/rmatvec are matmuls or stencils, and the proxes are O(n)/O(m)
elementwise. State is two
vectors (x, y).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ciao_tpu.ops.linmap import IdentityMap
from ciao_tpu.prox import Zero
from ciao_tpu.solvers.base import (
    SolverIterable,
    real_dtype_of,
    run_solver_loop,
)
from ciao_tpu.solvers.fb import full_gradient


def prox_conjugate(h, u, sigma):
    """prox_{σh*}(u) via the Moreau identity — the dual update of every
    primal-dual method, valid for ANY prox operator in the library."""
    return u - sigma * h.prox_only(u / sigma, 1.0 / sigma)


class PDCfg(NamedTuple):
    N: int


class PDState(NamedTuple):
    tau: jnp.ndarray     # scalar primal stepsize
    sigma: jnp.ndarray   # scalar dual stepsize
    x: jnp.ndarray       # (n,) primal iterate — the solution view
    y: jnp.ndarray       # (m,) dual iterate (in h*'s domain)
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x


@partial(jax.jit, static_argnames=("cfg",))
def pd_init(F, g, h, K, x0, tau, sigma, cfg: PDCfg) -> PDState:
    """x = x0, y = 0 — solution(init) == x0 (init is iteration #1)."""
    m = K.out_dim(x0.shape[0])
    return PDState(
        tau=tau, sigma=sigma, x=x0, y=jnp.zeros(m, x0.dtype),
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _pd_step(F, g, h, K, cfg: PDCfg, state: PDState,
             grad_fn=None) -> PDState:
    """One Condat-Vũ step. ``grad_fn`` lets the DP path substitute a
    psum-wrapped full gradient while reusing this body verbatim."""
    tau, sigma = state.tau, state.sigma
    if grad_fn is None:
        grad = full_gradient(F, cfg.N, state.x)
    else:
        grad = grad_fn(state.x)
    x_new = g.prox_only(state.x - tau * (grad + K.rmatvec(state.y)), tau)
    u = state.y + sigma * K.matvec(2.0 * x_new - state.x)
    y_new = prox_conjugate(h, u, sigma)
    return state._replace(x=x_new, y=y_new, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def pd_run(F, g, h, K, state, cfg: PDCfg, steps: int):
    def body(s, _):
        with jax.named_scope("pd_step"):
            return _pd_step(F, g, h, K, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def pd_step(F, g, h, K, state, cfg: PDCfg):
    return _pd_step(F, g, h, K, cfg, state)


@dataclasses.dataclass(frozen=True)
class CondatVu:
    """Primal-dual facade:
    ``CondatVu(...)(x0, F=F, g=g, h=h, K=K, L=L)`` minimizes
    (1/N)Σf_i + g(x) + h(Kx). Omit K for K = I; omit F/L for the
    Chambolle-Pock case (f = 0)."""

    tau: Optional[float] = None
    sigma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100

    def __post_init__(self):
        assert self.tau is None or self.tau > 0
        assert self.sigma is None or self.sigma > 0
        assert self.maxit > 0 and self.freq > 0

    def _stepsizes(self, Lf, normK, rdt):
        """σ = 1/‖K‖ (unless given), then the largest τ satisfying the
        convergence condition τ(L_f/2 + σ‖K‖²) ≤ 1 — with a 0.99 margin
        since ‖K‖ may be the exact norm, not a strict bound."""
        sigma = 1.0 / max(normK, 1e-12) if self.sigma is None else self.sigma
        if self.tau is not None:
            tau = self.tau
        else:
            tau = 0.99 / (Lf / 2.0 + sigma * normK * normK)
        if tau * (Lf / 2.0 + sigma * normK * normK) > 1.0 + 1e-9:
            import warnings

            warnings.warn(
                "CondatVu: τ(L_f/2 + σ‖K‖²) > 1 — the given stepsizes "
                "violate the convergence condition"
            )
        return jnp.asarray(tau, rdt), jnp.asarray(sigma, rdt)

    def _setup(self, x0, F, g, h, K, L, N):
        x0 = jnp.asarray(x0)
        from ciao_tpu.oracles import ZeroOracle

        if N is None:
            if F is None:
                raise ValueError("provide F or N")
            N = F.num_terms
        if F is None:
            F = ZeroOracle(n_terms=N)
        if g is None:
            g = Zero()
        if h is None:
            h = Zero()
        if K is None:
            K = IdentityMap()
        rdt = real_dtype_of(x0)
        if L is not None:
            Lf = float(jnp.mean(jnp.asarray(L, rdt)))
        elif isinstance(F, ZeroOracle):
            Lf = 0.0  # Chambolle-Pock: στ‖K‖² ≤ 1
        elif self.tau is not None:
            Lf = 0.0  # user owns the condition via explicit τ
        else:
            raise ValueError(
                "CondatVu: provide the smoothness moduli L, or an "
                "explicit stepsize τ"
            )
        tau, sigma = self._stepsizes(Lf, float(K.opnorm_bound(x0.shape[0])),
                                     rdt)
        cfg = PDCfg(N=N)
        init = lambda: pd_init(F, g, h, K, x0, tau, sigma, cfg)
        return x0, F, g, h, K, cfg, init

    def __call__(self, x0, F=None, g=None, h=None, K=None, L=None, N=None,
                 observe=None):
        x0, F, g, h, K, cfg, init = self._setup(x0, F, g, h, K, L, N)

        def run_chunk(state, k):
            return pd_run(F, g, h, K, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.tau):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp,
            observe,
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, K=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, h, K, cfg, init = self._setup(x0, F, g, h, K, L, N)
        step = lambda s: pd_step(F, g, h, K, s, cfg)
        # stateless in the oracle (full gradient recomputed per step)
        return SolverIterable(x0_orig, init, step, rebase_fn=lambda s: s)


def ChambollePock(**kwargs) -> CondatVu:
    """The f = 0 primal-dual method (Chambolle-Pock, JMIV 2011):
    minimize g(x) + h(Kx), both proximable — ``CondatVu`` called with
    no F/L. Default steps τ = σ = 1/‖K‖ satisfy στ‖K‖² ≤ 1."""
    return CondatVu(**kwargs)

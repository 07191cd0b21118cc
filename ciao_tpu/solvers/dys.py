"""Davis-Yin three-operator splitting — and Douglas-Rachford as its
f = 0 special case (BEYOND the reference).

The reference handles exactly two terms, smooth-finite-sum + one
proximable g. Its users' companion package ProximalAlgorithms.jl ships
``DavisYin`` / ``DouglasRachford`` for THREE-term objectives

    minimize_x  (1/N) Σ_i f_i(x)  +  g(x)  +  h(x)

with f smooth and BOTH g and h proximable (Davis & Yin, "A
three-operator splitting scheme and its optimization applications",
Set-Valued Var. Anal. 2017). The canonical use here: a constrained
sparse problem (lasso objective + box/simplex feasibility) without
needing the prox of the SUM g+h — which has no closed form in general.

One step, stepsize γ ∈ (0, 2/L_f), relaxation λ ∈ (0, 2 − γL_f/2):

    x_g = prox_{γg}(z)
    x_h = prox_{γh}(2·x_g − z − γ∇f(x_g))
    z⁺  = z + λ(x_h − x_g)

``solution(state) = x_g`` (the sequence that converges to the
minimizer; x_h is the h-feasible shadow). Special cases, pinned by
tests: h = Zero reduces to forward-backward on x_g (``_fb_step``
trajectory started from prox_g(x0)); f = 0 is Douglas-Rachford
splitting, exposed as :func:`DouglasRachford`.

Data path: the only O(N) work is the full gradient at x_g — ONE pass
over the oracle rows (`solvers.fb.full_gradient`, the same read FISTA
uses); the two proxes and the z-algebra are O(n) elementwise work XLA
fuses around it. No table, no sampling — state is
three (n,) vectors.

Reference for the two-term behavior being generalized:
`/root/reference/src/algorithms/Finito/Finito.jl:66-72` (smooth sum +
single g); the reference has no three-term capability.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ciao_tpu.prox import Zero
from ciao_tpu.solvers.base import (
    SolverIterable,
    real_dtype_of,
    run_solver_loop,
)
from ciao_tpu.solvers.fb import full_gradient


class DYSCfg(NamedTuple):
    N: int


class DYSState(NamedTuple):
    gamma: jnp.ndarray   # scalar stepsize
    lam: jnp.ndarray     # scalar relaxation
    z: jnp.ndarray       # (n,) governing sequence
    xg: jnp.ndarray      # (n,) last prox_g point — the solution view
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.xg


@partial(jax.jit, static_argnames=("cfg",))
def dys_init(F, g, h, x0, gamma, lam, cfg: DYSCfg) -> DYSState:
    """z = xg = x0 — solution(init) == x0 (init is iteration #1, the
    framework-wide convention; the first prox_g lands inside step 2)."""
    return DYSState(
        gamma=gamma, lam=lam, z=x0, xg=x0,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _dys_step(F, g, h, cfg: DYSCfg, state: DYSState,
              grad_fn=None) -> DYSState:
    """One Davis-Yin step. ``grad_fn`` lets the DP path substitute a
    psum-wrapped full gradient while reusing this body verbatim."""
    gamma = state.gamma
    xg = g.prox_only(state.z, gamma)
    if grad_fn is None:
        grad = full_gradient(F, cfg.N, xg)
    else:
        grad = grad_fn(xg)
    xh = h.prox_only(2.0 * xg - state.z - gamma * grad, gamma)
    z_new = state.z + state.lam * (xh - xg)
    return state._replace(z=z_new, xg=xg, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def dys_run(F, g, h, state, cfg: DYSCfg, steps: int):
    def body(s, _):
        with jax.named_scope("dys_step"):
            return _dys_step(F, g, h, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def dys_step(F, g, h, state, cfg: DYSCfg):
    return _dys_step(F, g, h, cfg, state)


@dataclasses.dataclass(frozen=True)
class DavisYin:
    """Three-operator splitting facade:
    ``DavisYin(...)(x0, F=F, g=g, h=h, L=L)`` minimizes
    (1/N)Σf_i + g + h with both g and h proximable.

    Default γ = 1/mean(L) (the full smooth term's modulus is ≤
    mean(L_i), same policy as :class:`ForwardBackward`), λ = 1.
    """

    gamma: Optional[float] = None
    lam: float = 1.0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert 0 < self.lam < 2
        assert self.maxit > 0 and self.freq > 0

    def _setup(self, x0, F, g, h, L, N):
        x0 = jnp.asarray(x0)
        if N is None:
            if F is None:
                raise ValueError("provide F or N")
            N = F.num_terms
        if F is None:
            from ciao_tpu.oracles import ZeroOracle
            F = ZeroOracle(n_terms=N)
        if g is None:
            g = Zero()
        if h is None:
            h = Zero()
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        elif L is not None:
            gamma = 1.0 / jnp.mean(jnp.asarray(L, rdt))
        else:
            from ciao_tpu.oracles import ZeroOracle
            if isinstance(F, ZeroOracle):
                gamma = jnp.ones((), rdt)  # f = 0: any γ>0 (DRS)
            else:
                raise ValueError(
                    "DavisYin: provide the smoothness moduli L, or a "
                    "stepsize γ"
                )
        lam = jnp.asarray(self.lam, rdt)
        cfg = DYSCfg(N=N)
        init = lambda: dys_init(F, g, h, x0, gamma, lam, cfg)
        return x0, F, g, h, cfg, init

    def __call__(self, x0, F=None, g=None, h=None, L=None, N=None,
                 observe=None):
        x0, F, g, h, cfg, init = self._setup(x0, F, g, h, L, N)

        def run_chunk(state, k):
            return dys_run(F, g, h, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp,
            observe,
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, h, cfg, init = self._setup(x0, F, g, h, L, N)
        step = lambda s: dys_step(F, g, h, s, cfg)
        # stateless in the oracle (full gradient recomputed per step) —
        # a storage switch self-heals
        return SolverIterable(x0_orig, init, step, rebase_fn=lambda s: s)


def DouglasRachford(**kwargs) -> DavisYin:
    """Douglas-Rachford splitting: minimize g(x) + h(x), both
    proximable — ``DavisYin`` with f = 0 (pass no F/L; γ defaults to
    1, any positive value converges for convex g, h)."""
    return DavisYin(**kwargs)

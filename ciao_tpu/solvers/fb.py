"""Forward-backward splitting (ISTA) and its accelerated variant
(FISTA) — deterministic full-gradient baselines (BEYOND the reference).

The reference ships only incremental/stochastic solvers, but its users
come from the ProximalAlgorithms.jl ecosystem whose ``ForwardBackward``
/ ``FastForwardBackward`` are the standard deterministic baselines every
experiment compares against (the reference's own companion package —
``Project.toml:9`` pulls ProximalAlgorithms for IterationTools). They
complete the library here so a switching user can reproduce those
comparisons in-framework:

    x⁺ = prox_{γg}(y − γ∇f(y)),        f = (1/N) Σ_i f_i

with y = x (ISTA) or the Nesterov extrapolation
y⁺ = x⁺ + ((t−1)/t⁺)(x⁺ − x), t⁺ = (1+√(1+4t²))/2 (FISTA, the O(1/k²)
rate). One step is ONE full-pass row read (``grad_sum_all`` — the same
reduction as the SVRG anchor) plus an O(n) prox: entirely
bandwidth-bound, no table, no sampling.

Default γ = 1/mean(L): each f_i has modulus L_i, so the full smooth
term (1/N)Σf_i has modulus ≤ mean(L_i).
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


class FBCfg(NamedTuple):
    N: int
    fast: bool = False   # Nesterov extrapolation (FISTA)


class FBState(NamedTuple):
    gamma: jnp.ndarray   # scalar stepsize
    t: jnp.ndarray       # scalar momentum sequence (1.0 when not fast)
    x: jnp.ndarray       # (n,) iterate
    y: jnp.ndarray       # (n,) extrapolated point (== x when not fast)
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x


@partial(jax.jit, static_argnames=("cfg",))
def fb_init(F, g, x0, gamma, cfg: FBCfg) -> FBState:
    """x = y = x0, t = 1 — solution(init) == x0 (init is iteration #1,
    the framework-wide convention)."""
    rdt = jnp.zeros((), jnp.result_type(x0)).real.dtype
    return FBState(
        gamma=gamma, t=jnp.ones((), rdt), x=x0, y=x0,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def full_gradient(F, N, y):
    """∇((1/N)Σf_i)(y) — shared by every deterministic full-gradient
    solver (FB/FISTA here, Davis-Yin, Condat-Vũ)."""
    return F.grad_sum_all(y) / N


def _fb_step(F, g, cfg: FBCfg, state: FBState) -> FBState:
    gamma = state.gamma
    grad = full_gradient(F, cfg.N, state.y)
    x_new = g.prox_only(state.y - gamma * grad, gamma)
    if cfg.fast:
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * state.t * state.t))
        y_new = x_new + ((state.t - 1.0) / t_new) * (x_new - state.x)
    else:
        t_new, y_new = state.t, x_new
    return state._replace(t=t_new, x=x_new, y=y_new, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def fb_run(F, g, state, cfg: FBCfg, steps: int):
    def body(s, _):
        with jax.named_scope("fb_step"):
            return _fb_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def fb_step(F, g, state, cfg: FBCfg):
    return _fb_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class ForwardBackward:
    """Proximal-gradient facade (deterministic baseline). ``fast=True``
    is FISTA; ``maxit`` counts full-gradient steps."""

    gamma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    fast: bool = False

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0

    def _setup(self, x0, F, g, L, N):
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
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = jnp.asarray(self.gamma, rdt)
        else:
            if L is None:
                raise ValueError(
                    "ForwardBackward: provide the smoothness moduli L, "
                    "or a stepsize γ"
                )
            gamma = 1.0 / jnp.mean(jnp.asarray(L, rdt))
        cfg = FBCfg(N=N, fast=self.fast)
        init = lambda: fb_init(F, g, x0, gamma, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return fb_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp,
            observe,
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        step = lambda s: fb_step(F, g, s, cfg)
        # stateless in the oracle: every step recomputes the full
        # gradient, so a storage switch self-heals (rebase identity)
        return SolverIterable(x0_orig, init, step, rebase_fn=lambda s: s)


def FISTA(**kwargs) -> ForwardBackward:
    """Accelerated forward-backward (``ForwardBackward(fast=True)``) —
    the FastForwardBackward of ProximalAlgorithms.jl."""
    return ForwardBackward(fast=True, **kwargs)

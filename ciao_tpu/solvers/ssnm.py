"""SSNM — SAGA with Sampled Negative Momentum (BEYOND the reference).

Zhou, Shang, Cheng, "Direct Acceleration of SAGA using Sampled Negative
Momentum" (AISTATS 2019; PAPERS.md): Katyusha-class acceleration,
O((N + √(Nκ))·log 1/ε), with a far LIGHTER state than Katyusha — no
three-sequence coupling and no outer loop; the negative momentum comes
from the SAMPLED term's own stored point:

    sample block j;   y_k = τ·x_k + (1−τ)·φ_j
    ∇̃  = ∇f_j(y_k) − ∇f_j(φ_j) + ḡ         ḡ = (1/N) Σ_i ∇f_i(φ_i)
    x_{k+1} = prox_{ηg}(x_k − η ∇̃)          η = 1/(3·τ·L) (mirror step)
    φ_j ← y_k

x plays Katyusha's MIRROR-sequence role: the gradient (evaluated at
the momentum point y) steps from x with the 1/τ-scaled stepsize —
exactly Katyusha's α = 1/(3τ₁L) coupling with the y-sequence replaced
by the sampled stored point. At τ = 1 this is verbatim minibatch SAGA.

Data path — the reason SSNM is a natural fit here: for rank-1 row
gradients the stored ∇f_i(φ_i) compress to the (N,) coefficient table,
so ``∇f_j(y) − ∇f_j(φ_j)`` IS the SAGA innovation Σ(c(y)_i − c_i)·a_i —
one block row read, one margin dot, one apply dot — and the sampled
points φ live as the per-BLOCK eval-point table ``zb (d, n)`` exactly
like the Finito coefficient state (uniform contiguous-block sampling:
a block's rows always share their last update point). Per step the
whole method costs the SAGA coefficient step plus one O(n) convex
combination. Single-loop, constant-shape state: checkpoints and
shards like SAGA's.

Tuning: τ defaults to ½ (measured ~10¹⁰× past SAGA at a matched
16k-step budget on the ill-conditioned planted lasso — tests pin ≥50×);
σ sets the Katyusha-style τ = min(½, √(N·σ/(3·L_max))) when given.
η defaults to the coupled 1/(3·τ·L_max). At τ = 1 the method
degenerates to exactly minibatch SAGA (y ≡ x), which the tests pin
bit-for-bit.

API matches the reference-style facades: ``SSNM(...)(x0, F=F, g=g,
L=L, N=N)`` and ``.iterator(...)``; solution(state) = x.
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


class SSNMCfg(NamedTuple):
    N: int
    batch: int = 1


class SSNMState(NamedTuple):
    tau: jnp.ndarray     # scalar momentum weight
    eta: jnp.ndarray     # scalar stepsize
    c: jnp.ndarray       # (N,) coefficient table c_i = c(φ_i)
    zb: jnp.ndarray      # (d, n) per-block stored points φ
    gbar: jnp.ndarray    # (n,) table mean ḡ = (1/N) Σ c_i·a_i
    x: jnp.ndarray       # (n,) iterate
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.x


@partial(jax.jit, static_argnames=("cfg",))
def ssnm_init(F, g, x0, tau, eta, key, cfg: SSNMCfg) -> SSNMState:
    """Table bootstrap φ_i = x0 (SAGA convention): coefficients at x0,
    ḡ their mean, every block's stored point x0; x = x0 so
    solution(init) == x0."""
    c = F.coeff_all(x0)
    gbar = F.apply_all(c) / cfg.N
    d = cfg.N // cfg.batch
    zb = jnp.broadcast_to(x0, (d,) + x0.shape)
    return SSNMState(
        tau=tau, eta=eta, c=c, zb=zb, gbar=gbar, x=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _ssnm_step(F, g, cfg: SSNMCfg, state: SSNMState) -> SSNMState:
    """One SSNM step on a uniformly-drawn contiguous block (the same
    stateless (key, it) stream as block SAGA)."""
    from ciao_tpu.solvers.saga import _block_start

    N, B = cfg.N, cfg.batch
    tau, eta = state.tau, state.eta
    start = _block_start(state.key, state.it, N, B)
    j = start // B
    phi = state.zb[j]                                  # (n,) stored point
    y = tau * state.x + (1.0 - tau) * phi              # sampled momentum
    c_new = F.coeff_block(y, start, B)
    c_old = jax.lax.dynamic_slice_in_dim(state.c, start, B)
    innov = F.apply_rows_block(c_new - c_old, start, B)
    grad = innov / B + state.gbar                      # ∇̃ (unbiased)
    x = g.prox_only(state.x - eta * grad, eta)         # mirror step
    gbar = state.gbar + innov / N                      # exact table mean
    c = jax.lax.dynamic_update_slice_in_dim(state.c, c_new, start, 0)
    zb = state.zb.at[j].set(y)                         # φ_block ← y
    return state._replace(c=c, zb=zb, gbar=gbar, x=x, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def ssnm_run(F, g, state, cfg: SSNMCfg, steps: int):

    def body(s, _):
        with jax.named_scope("ssnm_step"):
            return _ssnm_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def ssnm_step(F, g, state, cfg: SSNMCfg):
    return _ssnm_step(F, g, cfg, state)


@partial(jax.jit, static_argnames=("cfg",))
def ssnm_rebase(F, g, state, cfg: SSNMCfg):
    """Recompute ḡ exactly from the coefficient table under ``F``'s row
    storage — required after a storage swap (cf. saga_rebase)."""
    return state._replace(gbar=F.apply_all(state.c) / cfg.N)


@dataclasses.dataclass(frozen=True)
class SSNM:
    """SAGA with sampled negative momentum (beyond the reference).

    ``sigma`` — strong-convexity modulus of f (per-term average); sets
    τ = min(½, √(N·σ/(3·L_max))). Without it τ defaults to ½ (pass
    ``tau`` explicitly for problem-specific schedules; τ = 1 is exactly
    minibatch SAGA). ``eta`` defaults to 1/(3·L_max). ``maxit`` counts
    steps of ``batch`` rows (contiguous blocks are the only sampling
    mode; N must divide by batch)."""

    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    batch: int = 1
    tau: Optional[float] = None
    sigma: Optional[float] = None
    eta: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        assert self.maxit > 0 and self.freq > 0 and self.batch >= 1
        if self.tau is not None:
            assert 0.0 < self.tau <= 1.0
        assert self.eta is None or self.eta > 0

    def _setup(self, x0, F, g, L, N):
        x0 = jnp.asarray(x0)
        if N is None:
            if F is None:
                raise ValueError("provide F or N")
            N = F.num_terms
        if g is None:
            g = Zero()
        if not getattr(F, "supports_coeff", False):
            raise ValueError(
                "SSNM stores the sampled points per BLOCK, which needs a "
                f"rank-1 (coefficient) oracle; {type(F).__name__} is not"
            )
        if N % self.batch != 0:
            raise ValueError("SSNM needs N divisible by batch")
        rdt = real_dtype_of(x0)
        if L is None and (self.eta is None or (self.tau is None
                                               and self.sigma is not None)):
            raise ValueError("SSNM: provide the smoothness moduli L, or η/τ")
        Lmax = None if L is None else jnp.max(jnp.asarray(L, rdt))
        if self.tau is not None:
            tau = jnp.asarray(self.tau, rdt)
        elif self.sigma is not None:
            tau = jnp.minimum(
                jnp.sqrt(N * jnp.asarray(self.sigma, rdt) / (3.0 * Lmax)),
                jnp.asarray(0.5, rdt),
            )
        else:
            tau = jnp.asarray(0.5, rdt)
        eta = (jnp.asarray(self.eta, rdt) if self.eta is not None
               else 1.0 / (3.0 * tau * Lmax))  # the mirror coupling
        cfg = SSNMCfg(N=N, batch=self.batch)
        key = jax.random.PRNGKey(self.seed)
        init = lambda: ssnm_init(F, g, x0, tau, eta, key, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return ssnm_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.tau):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp,
            observe,
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        step = lambda s: ssnm_step(F, g, s, cfg)
        rebase = lambda s: ssnm_rebase(F, g, s, cfg)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)

"""L-SVRG — loopless SVRG (BEYOND the reference).

The reference's SVRG (``src/algorithms/SVRG/SVRG_basic.jl``) is
epoch-structured: m inner steps, then a mandatory full-gradient anchor
refresh and an iterate-averaging reset. L-SVRG (Kovalev, Horváth,
Richtárik, "Don't Jump Through Hoops and Remove Those Loops: SVRG and
Katyusha are Better Without the Outer Loop", ALT 2020; proximal form as
in Hofmann et al. 2015) removes the outer loop: every step is the same
variance-reduced prox step, and the anchor jumps to the current iterate
with a small probability p (a Bernoulli coin, in expectation one full
pass per 1/p steps):

    w⁺  = prox_{γg}(w − γ[∇f_i(w) − ∇f_i(z) + μ]),   μ = ∇f(z)
    z⁺  = w with probability p (anchor refresh: μ⁺ = ∇f(w)), else z

Same O((N + κ)log 1/ε) rate as SVRG with p = 1/N, but a single-loop
iteration structure: no inner-length tuning, no iterate-averaging
reset, and uniform per-step cost — which means ONE jitted step
fn (the refresh is a ``lax.cond`` full-pass branch) instead of SVRG's
nested inner scan, and a constant-shape state that checkpoints and
shards like SAGA's.

Data path: the per-step work is one contiguous-block row read
(``grad_sum_diff_block`` takes the live and anchor gradients over the
same rows — the SVRG/Katyusha/SARAH data path) + O(n) vector
algebra; the coin and the block draw are stateless (key, it) streams so
a ``lax.scan`` over steps stays a single dispatch. The refresh branch
is one full-pass reduction (``grad_sum_all``), paid with
probability p per step.

API matches the reference-style facades: ``LSVRG(...)(x0, F=F, g=g,
L=L, N=N)`` and ``.iterator(...)``; solution(state) = w (the current
iterate — there is no outer iterate to average).
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

# fold_in tag separating the per-step COIN stream from the per-step
# index stream (both are stateless in (key, it)); shared with the DP
# path so a D=1 mesh draws the same coins as the single-chip solver.
COIN_TAG = 0x1005E


def _coin(key, it, p):
    """The step-``it`` Bernoulli(p) anchor-refresh coin — deterministic
    in (key, it), independent of the index draw for the same step."""
    kc = jax.random.fold_in(jax.random.fold_in(key, it), COIN_TAG)
    return jax.random.uniform(kc, (), jnp.float32) < p


class LSVRGCfg(NamedTuple):
    N: int
    batch: int = 1
    block: bool = False  # uniform CONTIGUOUS block per step (slices)


class LSVRGState(NamedTuple):
    gamma: jnp.ndarray      # scalar stepsize
    p: jnp.ndarray          # scalar refresh probability (f32)
    av: jnp.ndarray         # (n,) full-gradient anchor μ = ∇f(z)
    z: jnp.ndarray          # (n,) anchor point
    w: jnp.ndarray          # (n,) iterate
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):    # the current iterate — no outer average
        return self.w


@partial(jax.jit, static_argnames=("cfg",))
def lsvrg_init(F, g, x0, gamma, p, key, cfg: LSVRGCfg) -> LSVRGState:
    """Anchor bootstrap at x0 (one full-gradient pass); w = z = x0, so
    solution(init) == x0 — init is iteration #1, the framework-wide
    convention."""
    av = F.grad_sum_all(x0) / cfg.N
    return LSVRGState(
        gamma=gamma, p=p, av=av, z=x0, w=x0, key=key,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _lsvrg_step(F, g, cfg: LSVRGCfg, state: LSVRGState) -> LSVRGState:
    """One loopless step: variance-reduced prox update + the Bernoulli
    anchor jump. Paper order (Kovalev et al., Alg. 2): the anchor jumps
    to the PRE-update iterate w_k — the point whose component gradient
    this step just evaluated."""
    from ciao_tpu.solvers.saga import _block_start

    N, B = cfg.N, cfg.batch
    gamma, av, w = state.gamma, state.av, state.w
    if cfg.block:
        start = _block_start(state.key, state.it, N, B)
        d = F.grad_sum_diff_block(state.z, w, start, B)
    else:
        ki = jax.random.fold_in(state.key, state.it)
        i = jax.random.randint(ki, (B,), 0, N, dtype=jnp.int32)
        d = F.grad_sum_diff(state.z, w, i)
    # d = Σ_B (∇f_i(z) − ∇f_i(w)): update w + γ(d/B − μ) ≡ the descent
    # step w − γ[∇f_i(w) − ∇f_i(z) + μ] (the SVRG inner form)
    w_new = g.prox_only(w + gamma * (d / B - av), gamma)
    flip = _coin(state.key, state.it, state.p)
    z_new, av_new = jax.lax.cond(
        flip,
        lambda: (w, F.grad_sum_all(w) / N),
        lambda: (state.z, state.av),
    )
    return state._replace(
        av=av_new, z=z_new, w=w_new, it=state.it + 1
    )


@partial(jax.jit, static_argnames=("cfg", "steps"))
def lsvrg_run(F, g, state, cfg: LSVRGCfg, steps: int):

    def body(s, _):
        with jax.named_scope("lsvrg_step"):
            return _lsvrg_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def lsvrg_step(F, g, state, cfg: LSVRGCfg):
    return _lsvrg_step(F, g, cfg, state)


@partial(jax.jit, static_argnames=("cfg",))
def lsvrg_rebase(F, g, state, cfg: LSVRGCfg):
    """Exact anchor-gradient recompute at the CURRENT anchor point —
    required after an oracle row-storage swap (the carried μ keeps the
    old operator's gradient until the next coin fires, which at small p
    is arbitrarily far away)."""
    return state._replace(av=F.grad_sum_all(state.z) / cfg.N)


@dataclasses.dataclass(frozen=True)
class LSVRG:
    """Loopless-SVRG facade (beyond the reference).

    ``p`` — anchor refresh probability per step; defaults to batch/N
    (in expectation one full pass per epoch of samples, SVRG's refresh
    cadence). ``gamma`` defaults to 1/(6·L_max), the paper's rate-
    optimal stepsize at p = 1/N. ``maxit`` counts STEPS (one block
    read each), not epochs."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    batch: int = 1
    block_sampling: bool = False  # contiguous blocks (slices, no gather)
    seed: int = 0

    def __post_init__(self):
        assert self.gamma is None or self.gamma > 0
        assert self.maxit > 0 and self.freq > 0 and self.batch >= 1
        assert self.p is None or 0.0 <= self.p <= 1.0

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
                raise ValueError("LSVRG: provide L or γ")
            gamma = 1.0 / (6.0 * jnp.max(jnp.asarray(L, rdt)))
        p = self.batch / N if self.p is None else self.p
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("LSVRG block_sampling needs N divisible by batch")
        cfg = LSVRGCfg(N=N, batch=self.batch, block=self.block_sampling)
        key = jax.random.PRNGKey(self.seed)
        p = jnp.asarray(p, jnp.float32)
        init = lambda: lsvrg_init(F, g, x0, gamma, p, key, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return lsvrg_run(F, g, state, cfg, k)

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
        step = lambda s: lsvrg_step(F, g, s, cfg)
        rebase = lambda s: lsvrg_rebase(F, g, s, cfg)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


# ---------------------------------------------------------------------------
# L-Katyusha — the loopless accelerated sibling (same paper)
# ---------------------------------------------------------------------------

class LKatyushaCfg(NamedTuple):
    N: int
    batch: int = 1
    block: bool = False


class LKatyushaState(NamedTuple):
    Lmax: jnp.ndarray       # scalar smoothness bound
    sigma: jnp.ndarray      # scalar σ̂ = μ/L_max (0 allowed: plain mirror step)
    theta1: jnp.ndarray     # scalar momentum weight
    theta2: jnp.ndarray     # scalar anchor weight
    p: jnp.ndarray          # scalar refresh probability (f32)
    av: jnp.ndarray         # (n,) full-gradient anchor μ = ∇f(w_anchor)
    w_anchor: jnp.ndarray   # (n,) anchor point
    y: jnp.ndarray          # (n,) gradient-step sequence
    z: jnp.ndarray          # (n,) mirror-step sequence
    key: jnp.ndarray
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):     # the y sequence carries the O(√κ) guarantee
        return self.y


@partial(jax.jit, static_argnames=("cfg",))
def lkatyusha_init(F, g, x0, Lmax, sigma, theta1, theta2, p, key,
                   cfg: LKatyushaCfg) -> LKatyushaState:
    """Anchor bootstrap at x0; y = z = w = x0, so solution(init) == x0."""
    av = F.grad_sum_all(x0) / cfg.N
    return LKatyushaState(
        Lmax=Lmax, sigma=sigma, theta1=theta1, theta2=theta2, p=p, av=av,
        w_anchor=x0, y=x0, z=x0, key=key, it=jnp.ones((), jnp.int32),
        status=jnp.zeros((), jnp.int32),
    )


def _lkatyusha_step(F, g, cfg: LKatyushaCfg,
                    state: LKatyushaState) -> LKatyushaState:
    """One loopless accelerated step (Kovalev et al., Alg. 3; proximal
    z-update): with σ̂ = μ/L, η = θ₂/((1+θ₂)θ₁),

        x   = θ₁ z + θ₂ w + (1−θ₁−θ₂) y
        ∇̃  = μ + (1/B) Σ_B [∇f_i(x) − ∇f_i(w)]
        z⁺  = prox_{τψ}((z + ησ̂x − (η/L)∇̃)/(1+ησ̂)),  τ = η/(L(1+ησ̂))
        y⁺  = x + θ₁ (z⁺ − z)
        w⁺  = y with probability p (anchor refresh μ⁺ = ∇f(y)), else w

    At σ̂ = 0 the z-update reduces to the plain mirror step
    prox_{(η/L)ψ}(z − (η/L)∇̃). The anchor jumps to the CURRENT y (the
    paper's order: w⁺ uses the pre-update y sequence)."""
    from ciao_tpu.solvers.saga import _block_start

    N, B = cfg.N, cfg.batch
    th1, th2, sig = state.theta1, state.theta2, state.sigma
    eta = th2 / ((1.0 + th2) * th1)
    step = eta / state.Lmax            # η/L
    av, w = state.av, state.w_anchor
    x = th1 * state.z + th2 * w + (1.0 - th1 - th2) * state.y
    if cfg.block:
        start = _block_start(state.key, state.it, N, B)
        d = F.grad_sum_diff_block(x, w, start, B)
    else:
        ki = jax.random.fold_in(state.key, state.it)
        i = jax.random.randint(ki, (B,), 0, N, dtype=jnp.int32)
        d = F.grad_sum_diff(x, w, i)
    gr = av + d / B                    # ∇̃ (grad_sum_diff = Σ ∇f_i(x) − ∇f_i(w))
    denom = 1.0 + eta * sig
    tau = step / denom
    z_new = g.prox_only((state.z + (eta * sig) * x - step * gr) / denom, tau)
    y_new = x + th1 * (z_new - state.z)
    flip = _coin(state.key, state.it, state.p)
    w_new, av_new = jax.lax.cond(
        flip,
        lambda: (state.y, F.grad_sum_all(state.y) / N),
        lambda: (state.w_anchor, state.av),
    )
    return state._replace(
        av=av_new, w_anchor=w_new, y=y_new, z=z_new, it=state.it + 1
    )


@partial(jax.jit, static_argnames=("cfg", "steps"))
def lkatyusha_run(F, g, state, cfg: LKatyushaCfg, steps: int):

    def body(s, _):
        with jax.named_scope("lkatyusha_step"):
            return _lkatyusha_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def lkatyusha_step(F, g, state, cfg: LKatyushaCfg):
    return _lkatyusha_step(F, g, cfg, state)


@partial(jax.jit, static_argnames=("cfg",))
def lkatyusha_rebase(F, g, state, cfg: LKatyushaCfg):
    """Exact anchor-gradient recompute at the current anchor point —
    required after an oracle row-storage swap (cf. lsvrg_rebase)."""
    return state._replace(av=F.grad_sum_all(state.w_anchor) / cfg.N)


@dataclasses.dataclass(frozen=True)
class LKatyusha:
    """Loopless-Katyusha facade (beyond the reference) — accelerated
    loopless variance reduction (Kovalev, Horváth, Richtárik, ALT 2020;
    proximal z-update).

    ``sigma`` — strong-convexity-to-smoothness ratio σ̂ = μ/L_max; sets
    θ₁ = min(√(2σ̂N/3·batch), 1/2) (the paper's p = 1/N tuning, scaled
    by the minibatch). Omitted → σ̂ = 0 (plain mirror z-step) with
    θ₁ = 1/3 unless overridden. ``p`` defaults to batch/N. ``maxit``
    counts STEPS."""

    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    batch: int = 1
    theta1: Optional[float] = None
    theta2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False
    seed: int = 0

    def __post_init__(self):
        assert self.maxit > 0 and self.freq > 0 and self.batch >= 1
        assert 0.0 < self.theta2 < 1.0
        assert self.p is None or 0.0 <= self.p <= 1.0
        if self.theta1 is not None:
            assert 0.0 < self.theta1 <= 1.0 - self.theta2

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
        if L is None:
            raise ValueError("LKatyusha: provide the smoothness moduli L")
        rdt = real_dtype_of(x0)
        Lmax = jnp.max(jnp.asarray(L, rdt))
        sigma = jnp.asarray(
            0.0 if self.sigma is None else self.sigma, rdt
        )
        if self.theta1 is not None:
            theta1 = jnp.asarray(self.theta1, rdt)
        elif self.sigma is not None:
            theta1 = jnp.minimum(
                jnp.sqrt(2.0 * sigma * N / (3.0 * self.batch)),
                jnp.asarray(0.5, rdt),
            )
        else:
            theta1 = jnp.asarray(1.0 / 3.0, rdt)
        p = self.batch / N if self.p is None else self.p
        if self.block_sampling and N % self.batch != 0:
            raise ValueError(
                "LKatyusha block_sampling needs N divisible by batch"
            )
        cfg = LKatyushaCfg(N=N, batch=self.batch, block=self.block_sampling)
        key = jax.random.PRNGKey(self.seed)
        p = jnp.asarray(p, jnp.float32)
        theta2 = jnp.asarray(self.theta2, rdt)
        init = lambda: lkatyusha_init(
            F, g, x0, Lmax, sigma, theta1, theta2, p, key, cfg
        )
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return lkatyusha_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.theta1):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp,
            observe,
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        step = lambda s: lkatyusha_step(F, g, s, cfg)
        rebase = lambda s: lkatyusha_rebase(F, g, s, cfg)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)

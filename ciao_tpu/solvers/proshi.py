"""ProShI — proximal sharing-problem incremental solver.

Re-design of reference ``src/algorithms/ProShI/ProShI_basic.jl`` for

    minimize (1/N) Σ_i f_i(x_i) + g(Σ_i x_i)

Each block variable x_i is a row of the (N, n) table ``s``; the
coupling runs through ``av = Σ_i s_i`` (on a device mesh this is the
psum/all-reduce of the data axis) and the dual-like coupling variable

    z = (prox_g(av, hat_γ) - av) / hat_γ,   hat_γ = Σ_i γ_i

(NOTE: hat_γ is the SUM here, not the harmonic mean as in Finito —
ProShI_basic.jl:82 vs Finito_basic.jl:82.)

Per-index update (ProShI_basic.jl:111-120), batched exactly (every i in
a batch reads the same z and the av deltas are additive):

    s_i <- (s_i + γ_i z) - (γ_i/N) ∇f_i(s_i + γ_i z);  av += Δs_i

``solution(state)`` materializes the PURE view x_i = s_i + γ_i z
(the reference mutates its table in place here, ProShI_basic.jl:127-132,
which corrupts repeated calls — we return a fresh array instead and
document the deviation).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ciao_tpu.prox import Zero
from ciao_tpu.sampling import Sweep, SweepState, init_sweep, next_block, next_block_id
from ciao_tpu.solvers.base import (
    SolverIterable,
    real_dtype_of,
    resolve_gamma_array,
    run_solver_loop,
)


class ProshiCfg(NamedTuple):
    N: int
    batch: int
    sweeping: int
    alpha: float
    # random sweeping draws contiguous random BLOCKS from the stateless
    # (key, pos) stream instead of scattered without-replacement index
    # sets — the sanctioned batched form (cf. SAGA block_sampling; the
    # DP path already samples blocks).
    block_sampling: bool = False


class ProshiState(NamedTuple):
    s: jnp.ndarray          # (N, n) block table
    gamma: jnp.ndarray      # (N,)
    hat_gamma: jnp.ndarray  # Σ γ_i
    av: jnp.ndarray         # (n,) Σ_i s_i
    z: jnp.ndarray          # (n,) coupling variable
    sweep: SweepState
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        # pure view of the N block solutions x_i = s_i + γ_i z
        return self.s + self.gamma[:, None] * self.z[None, :]


def _coupling(g, av, hat_gamma):
    z = g.prox_only(av, hat_gamma)
    return (z - av) / hat_gamma


def _two_sum(hi, lo, p):
    """Knuth two-sum: (hi, lo) ← (hi, lo) + p, capturing the rounding
    error of the add exactly into the compensation term (the
    solvers/polish.py chunk-carry pattern applied to the block table)."""
    s = hi + p
    t = s - hi
    e = (p - t) + (hi - (s - t))
    return s, lo + e


def _resync_chunk_of(N: int, chunk: int) -> int:
    c = min(chunk, N)
    while N % c:
        c -= 1
    return c


@partial(jax.jit, static_argnames=("chunk",))
def _av_compensated(s, chunk: int):
    """Σ_i s_i over the (N, n) block table with per-chunk sums and a
    compensated (two-sum) cross-chunk carry: one-shot f32 error drops
    from ~√N·eps to ~√chunk·eps + O(eps²)."""
    N, n = s.shape
    z0 = jnp.zeros(n, s.dtype)

    def body(carry, i):
        hi, lo = carry
        blk = jax.lax.dynamic_slice_in_dim(s, i * chunk, chunk, 0)
        return _two_sum(hi, lo, jnp.sum(blk, axis=0)), None

    (hi, lo), _ = jax.lax.scan(body, (z0, z0), jnp.arange(N // chunk))
    return hi + lo


@partial(jax.jit, static_argnames=("chunk",))
def _proshi_resync_jit(g, state: ProshiState, chunk: int) -> ProshiState:
    av = _av_compensated(state.s, chunk)
    return state._replace(av=av, z=_coupling(g, av, state.hat_gamma))


def proshi_resync(g, state: ProshiState, chunk: int = 4096) -> ProshiState:
    """Recompute the coupling sum ``av = Σ_i s_i`` EXACTLY (compensated
    chunked reduction) and refresh ``z``.

    Why this matters for deep targets: ProShI maintains ``av``
    incrementally (``av += Σ_B Δs``, reference ProShI_basic.jl:113-123)
    — in f32 the per-step rounding drifts, and a drift δ displaces the
    algorithm's fixed point so that the coupling sum becomes
    ``prox_g(av_true + δ) − δ``: the soft-threshold's EXACT zeros on the
    off-support coordinates are destroyed, which costs a FIRST-order
    λ‖δ‖₁ in the sharing objective (everything else is second-order —
    the f32 table itself is not the floor). Resyncing at chunk
    boundaries removes the drift; :func:`deep_solve_sharing` packages
    the schedule. The DP local path already resyncs exactly at every
    round boundary (parallel/dp.py) — this is the single-chip analog."""
    return _proshi_resync_jit(g, state,
                              _resync_chunk_of(state.s.shape[0], chunk))


@partial(jax.jit, static_argnames=("chunk",))
def _sharing_objective_jit(F, g, state: ProshiState, chunk: int):
    N, n = state.s.shape
    z0 = jnp.zeros((), state.s.dtype)

    def body(carry, i):
        hi, lo = carry
        start = i * chunk
        s_blk = jax.lax.dynamic_slice_in_dim(state.s, start, chunk, 0)
        g_blk = jax.lax.dynamic_slice_in_dim(state.gamma, start, chunk)
        x_blk = s_blk + g_blk[:, None] * state.z[None, :]
        idx = start + jnp.arange(chunk)
        vals, _ = F.value_and_grad_pointwise(x_blk, idx)
        return _two_sum(hi, lo, jnp.sum(vals)), None

    (hi, lo), _ = jax.lax.scan(body, (z0, z0), jnp.arange(N // chunk))
    # Σ_i x_i = Σ_i s_i + (Σ_i γ_i) z — no (N, n) temp materialized
    u = _av_compensated(state.s, chunk) + state.hat_gamma * state.z
    return (hi + lo) / N + g.value(u)


def sharing_objective(F, g, state: ProshiState, chunk: int = 4096):
    """The sharing objective (1/N) Σ_i f_i(x_i) + g(Σ_i x_i) at the
    state's block solution, with compensated chunked reductions for both
    the value sum and the coupling sum (deep-target evaluation needs
    this: a monolithic f32 reduction over N blocks cannot resolve
    rel ≤ 1e-6)."""
    return _sharing_objective_jit(F, g, state,
                                  _resync_chunk_of(state.s.shape[0], chunk))


@partial(jax.jit, static_argnames=("cfg",))
def proshi_init(F, g, x0, gamma, key, cfg: ProshiCfg) -> ProshiState:
    """Reference ProShI_basic.jl:45-90."""
    N = cfg.N
    G = F.grad_all(x0)
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = jnp.sum(gamma)
    av = jnp.sum(s, axis=0)
    z = _coupling(g, av, hat_gamma)
    sweep = init_sweep(key, N, cfg.batch, cfg.sweeping)
    return ProshiState(
        s=s, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z, sweep=sweep,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _proshi_step(F, g, cfg: ProshiCfg, state: ProshiState) -> ProshiState:
    """Reference ProShI_basic.jl:93-125, batched."""
    N, B = cfg.N, cfg.batch
    if (cfg.sweeping != Sweep.RANDOM or cfg.block_sampling) and N % B == 0:
        # contiguous blocks (dynamic slices; see finito.py note)
        block, sweep = next_block_id(state.sweep, N, B, cfg.sweeping)
        start = block * B
        gi = jax.lax.dynamic_slice_in_dim(state.gamma, start, B)
        s_old = jax.lax.dynamic_slice_in_dim(state.s, start, B, 0)
        s_tmp = s_old + gi[:, None] * state.z[None, :]
        G_B = F.grad_pointwise_block(s_tmp, start, B)
        s_new = s_tmp - (gi / N)[:, None] * G_B
        av = state.av + jnp.sum(s_new - s_old, axis=0)
        s = jax.lax.dynamic_update_slice_in_dim(state.s, s_new, start, 0)
    else:
        idx, mask, sweep = next_block(state.sweep, N, B, cfg.sweeping)
        gi = state.gamma[idx]                         # (B,)
        s_old = state.s[idx]                          # (B, n)
        s_tmp = s_old + gi[:, None] * state.z[None, :]
        G_B = F.grad_pointwise(s_tmp, idx)            # per-block eval points
        s_new = s_tmp - (gi / N)[:, None] * G_B
        delta_rows = jnp.where(mask[:, None], s_new - s_old, 0)
        av = state.av + jnp.sum(delta_rows, axis=0)
        s = state.s.at[idx].add(delta_rows)
    z = _coupling(g, av, state.hat_gamma)
    return state._replace(s=s, av=av, z=z, sweep=sweep, it=state.it + 1)


@partial(jax.jit, static_argnames=("cfg", "steps"))
def proshi_run(F, g, state, cfg: ProshiCfg, steps: int):

    def body(s, _):
        with jax.named_scope("proshi_step"):
            return _proshi_step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg",))
def proshi_step(F, g, state, cfg: ProshiCfg):
    return _proshi_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class Proshi:
    """ProShI facade (reference ``ProShI.jl:18-40``)."""

    gamma: Optional[object] = None
    sweeping: int = 1
    minibatch: Tuple[bool, int] = (False, 1)
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    # random sweeping: draw contiguous random BLOCKS (stateless stream)
    # instead of the reference's scattered without-replacement index
    # sets — the sanctioned batched form (cf. SAGA ``block_sampling``;
    # DPProshi already samples blocks).
    block_sampling: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.gamma is not None:
            assert np.min(np.asarray(self.gamma)) > 0
        assert self.maxit > 0
        assert self.freq > 0
        assert self.sweeping in (1, 2, 3)
        if self.block_sampling:
            assert self.sweeping == Sweep.RANDOM, (
                "block_sampling only modifies random sweeping"
            )

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
        gamma = resolve_gamma_array(self.gamma, L, N, self.alpha, rdt, who="ProShI")
        if self.block_sampling and N % self.minibatch[1] != 0:
            raise ValueError(
                "ProShI block_sampling needs N divisible by the batch"
            )
        cfg = ProshiCfg(
            N=N, batch=self.minibatch[1], sweeping=self.sweeping,
            alpha=float(self.alpha), block_sampling=self.block_sampling,
        )
        key = jax.random.PRNGKey(self.seed)
        init = lambda: proshi_init(F, g, x0, gamma, key, cfg)
        return x0, F, g, cfg, init

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return proshi_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.hat_gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        step = lambda s: proshi_step(F, g, s, cfg)
        # ProShI oracles have no narrow-storage modes and the state
        # is storage-consistent: rebase is identity
        return SolverIterable(x0_orig, init, step, rebase_fn=lambda s: s)

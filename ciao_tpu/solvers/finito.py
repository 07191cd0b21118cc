"""Finito/MISO/DIAG solver family — basic, low-memory (LFinito), and
adaptive (backtracking) variants, with minibatching and three sweeping
strategies.

Re-design of the reference kernels (capability parity, accelerator-first
data layout):

  * basic:    reference ``src/algorithms/Finito/Finito_basic.jl`` —
              table s_i = x_i - (γ_i/N) ∇f_i(x_i) kept as ONE (N, n)
              HBM-resident array; the per-minibatch update is a gather +
              batched gradient + scatter-add, exact w.r.t. the
              reference's sequential per-index loop because every i in a
              batch reads the same z (Finito_basic.jl:110-118).
  * LFinito:  reference ``Finito_LFinito.jl`` — O(n) memory; one iterate
              = full-gradient pass + a ``lax.scan`` over minibatch
              blocks, with the per-block gradient-difference sum taken
              as a single matmul pair via ``grad_sum_diff``.
  * adaptive: reference ``Finito_adaptive.jl`` — per-index backtracking
              line search as a ``lax.while_loop``; early abort on γ
              underflow surfaces as ``Status.GAMMA_UNDERFLOW`` in the
              carry instead of returning ``nothing``.

Stepsize algebra (Finito_basic.jl:82-84): γ_i = α N / L_i,
hat_γ = 1 / Σ(1/γ_i), av = hat_γ Σ s_i/γ_i, z = prox_g(av, hat_γ).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ciao_tpu.prox import Zero
from ciao_tpu.sampling import (
    Sweep,
    SweepState,
    init_sweep,
    next_block,
    next_block_id,
    num_blocks,
)
from ciao_tpu.solvers.base import (
    SolverIterable,
    Status,
    real_dtype_of,
    resolve_gamma_array,
    run_solver_loop,
)


class FinitoCfg(NamedTuple):
    """Hashable static solver configuration (jit cache key)."""

    N: int
    batch: int
    sweeping: int
    alpha: float
    tol_b: float = 1e-9
    cyclic_pos0: int = 1  # basic starts its cyclic sweep at block 2 (see sampling)
    # Lipschitz-proportional block draws (sampling.systematic_block over
    # the stateless (key, it) stream) replace the RANDOM sweep.
    # Finito is a pure anchor-table method — its fixed point (all
    # anchors consistent at z*) is schedule-independent, so non-uniform
    # draws need no correction anywhere: hot (large-L) anchors are
    # simply refreshed more often, and their 1/γ_i ∝ L_i weights
    # already dominate the av mean. Per-index γ_i = αN/L_i unchanged.
    importance: bool = False


class FinitoBasicState(NamedTuple):
    s: jnp.ndarray          # (N, n) table of x_j - (γ_j/N) ∇f_j(x_j)
    gamma: jnp.ndarray      # (N,)
    hat_gamma: jnp.ndarray  # scalar
    av: jnp.ndarray         # (n,) running average
    z: jnp.ndarray          # (n,) prox point
    sweep: SweepState
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):  # reference: solution(state) = state.z
        return self.z


class FinitoCoeffState(NamedTuple):
    """Coefficient-compressed Finito-basic state (rank-1 row gradients):
    the (N, n) table s_i = z_b − (γ_i/N)·c_i·a_i is reconstructed from
    the (N,) coefficients ``c`` and the per-block eval points ``zb``
    (d, n) — an EXACT re-parameterization of the basic variant under
    contiguous block sweeps, with 1/n the memory and half the traffic."""

    c: jnp.ndarray          # (N,) gradient coefficients
    zb: jnp.ndarray         # (d, n) eval point of each block's last update
    invg: jnp.ndarray       # (d,) per-block Σ 1/γ_i
    gamma: jnp.ndarray      # (N,)
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    sweep: SweepState
    it: jnp.ndarray
    status: jnp.ndarray
    # importance mode only (leafless None otherwise): the π-scale CDF
    # of sampling.systematic_schedule
    qcum: object = None

    @property
    def solution(self):
        return self.z


class LFinitoState(NamedTuple):
    gamma: jnp.ndarray
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    z_full: jnp.ndarray
    sweep: SweepState
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z


class FinitoAdaptiveState(NamedTuple):
    s: jnp.ndarray          # (N, n) table of x_j
    gradf: jnp.ndarray      # (N, n) gradient table
    fi_x: jnp.ndarray       # (N,) value table
    gamma: jnp.ndarray      # (N,)
    hat_gamma: jnp.ndarray
    av: jnp.ndarray
    z: jnp.ndarray
    sweep: SweepState
    it: jnp.ndarray
    status: jnp.ndarray

    @property
    def solution(self):
        return self.z


# ---------------------------------------------------------------------------
# basic variant
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def finito_basic_init(F, g, x0, gamma, key, cfg: FinitoCfg) -> FinitoBasicState:
    """Cold start (reference Finito_basic.jl:44-89): full gradient pass
    fills the table, then the aggregate/prox bootstrap."""
    N = cfg.N
    G = F.grad_all(x0)                                   # (N, n), one matmul
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = 1.0 / jnp.sum(1.0 / gamma)
    av = hat_gamma * jnp.sum(s / gamma[:, None], axis=0)
    z = g.prox_only(av, hat_gamma)
    sweep = init_sweep(key, N, cfg.batch, cfg.sweeping)
    if cfg.sweeping == Sweep.CYCLIC:
        sweep = sweep._replace(pos=jnp.asarray(cfg.cyclic_pos0, jnp.int32))
    return FinitoBasicState(
        s=s, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z, sweep=sweep,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _use_contiguous(cfg) -> bool:
    """Cyclic/shuffled sweeps with evenly-dividing batches pick STATIC
    CONTIGUOUS blocks (Finito_basic.jl:50-58) — served by dynamic
    slices instead of a row gather and scatter."""
    return cfg.sweeping != Sweep.RANDOM and cfg.N % cfg.batch == 0


def _finito_basic_step(F, g, cfg: FinitoCfg, state: FinitoBasicState) -> FinitoBasicState:
    """Hot step (reference Finito_basic.jl:91-121), batched exactly:
    s_i <- z - (γ_i/N) ∇f_i(z);  av += Σ_i (s_i^new - s_i^old)·hat_γ/γ_i;
    z <- prox_g(av, hat_γ)."""
    N, B = cfg.N, cfg.batch
    if _use_contiguous(cfg):
        block, sweep = next_block_id(state.sweep, N, B, cfg.sweeping)
        start = block * B
        gi = jax.lax.dynamic_slice_in_dim(state.gamma, start, B)
        G_B = F.grad_block(state.z, start, B)
        s_new = state.z[None, :] - (gi / N)[:, None] * G_B
        s_old = jax.lax.dynamic_slice_in_dim(state.s, start, B, 0)
        av = state.av + jnp.sum(
            (s_new - s_old) * (state.hat_gamma / gi)[:, None], axis=0
        )
        s = jax.lax.dynamic_update_slice_in_dim(state.s, s_new, start, 0)
    else:
        idx, mask, sweep = next_block(state.sweep, N, B, cfg.sweeping)
        gi = state.gamma[idx]                             # (B,)
        G_B = F.grad_batch(state.z, idx)                  # (B, n)
        s_new = state.z[None, :] - (gi / N)[:, None] * G_B
        s_old = state.s[idx]
        delta_rows = jnp.where(mask[:, None], s_new - s_old, 0)
        av = state.av + jnp.sum(
            delta_rows * (state.hat_gamma / gi)[:, None], axis=0
        )
        # scatter-ADD keeps padded duplicate indices harmless (they add 0)
        s = state.s.at[idx].add(delta_rows)
    z = g.prox_only(av, state.hat_gamma)
    return state._replace(s=s, av=av, z=z, sweep=sweep, it=state.it + 1)


# ---------------------------------------------------------------------------
# coefficient-compressed basic variant (rank-1 row-gradient oracles)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def finito_coeff_init(F, g, x0, gamma, key, cfg: FinitoCfg) -> FinitoCoeffState:
    """Same bootstrap algebra as finito_basic_init (Finito_basic.jl:44-89)
    in the compressed parameterization: s_i = x0 − (γ_i/N)c_i·a_i, so
    av = hat_γ·(Σ1/γ_i)·x0 − (hat_γ/N)·Σ c_i a_i."""
    N, B = cfg.N, cfg.batch
    d = N // B
    c = F.coeff_all(x0)
    inv_gamma = 1.0 / gamma
    hat_gamma = 1.0 / jnp.sum(inv_gamma)
    av = hat_gamma * jnp.sum(inv_gamma) * x0 - (hat_gamma / N) * F.apply_all(c)
    z = g.prox_only(av, hat_gamma)
    invg = jnp.sum(inv_gamma.reshape(d, B), axis=1)
    zb = jnp.broadcast_to(x0, (d,) + x0.shape)
    sweep = init_sweep(key, N, B, cfg.sweeping)
    if cfg.sweeping == Sweep.CYCLIC:
        sweep = sweep._replace(pos=jnp.asarray(cfg.cyclic_pos0, jnp.int32))
    return FinitoCoeffState(
        c=c, zb=zb, invg=invg, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z,
        sweep=sweep, it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


@partial(jax.jit, static_argnames=("cfg",))
def finito_rebase(F, g, state, cfg: FinitoCfg):
    """Make the running average consistent with the table under ``F``'s
    row storage (see ``saga.saga_rebase`` — same failure mode: after a
    mid-run storage swap the delta-maintained ``av`` keeps the OLD
    operator's bias forever). Coefficient-mode identity:

        av = hat_γ·Σ_i s_i/γ_i,  s_i = zb_{b(i)} − (γ_i/N)·c_i·a_i
           = hat_γ·(Σ_j invg_j·zb_j − (1/N)·Σ_i c_i·a_i)

    so one pass over A (``apply_all``) repairs it; ``z`` is re-proxed to
    keep the z = prox(av, hat_γ) step invariant. LFinito and SVRG
    recompute their anchor from a full pass every epoch, so they
    self-heal after one epoch and need no rebase; the full-table basic
    state stores the s_i vectors themselves (storage-independent) — any
    non-coefficient state is returned unchanged."""
    if not isinstance(state, FinitoCoeffState):
        return state
    hat = state.hat_gamma
    av = hat * (state.invg @ state.zb) - (hat / cfg.N) * F.apply_all(state.c)
    return state._replace(av=av, z=g.prox_only(av, hat))


def _finito_coeff_step(F, g, cfg: FinitoCfg, state: FinitoCoeffState):
    """Exact re-parameterization of the basic hot step over a contiguous
    block (Finito_basic.jl:110-118):

        Σ_B (s_new−s_old)·hat_γ/γ_i
          = hat_γ·(Σ_B 1/γ_i)(z − z_b) − (hat_γ/N)·Σ_B (c_new−c_old)·a_i

    — two matvecs over the SAME oracle rows, zero table IO."""
    N, B = cfg.N, cfg.batch
    hat = state.hat_gamma
    if cfg.importance:
        from ciao_tpu.sampling import systematic_block

        block = systematic_block(state.sweep.key, state.it, state.qcum,
                                 N // B)
        sweep = state.sweep          # stateless (key, it) schedule
    else:
        block, sweep = next_block_id(state.sweep, N, B, cfg.sweeping)
    start = block * B
    c_new = F.coeff_block(state.z, start, B)
    c_old = jax.lax.dynamic_slice_in_dim(state.c, start, B)
    z_b = state.zb[block]
    innov = hat * state.invg[block] * (state.z - z_b) - (hat / N) * (
        F.apply_rows_block(c_new - c_old, start, B)
    )
    av = state.av + innov
    c = jax.lax.dynamic_update_slice_in_dim(state.c, c_new, start, 0)
    zb = state.zb.at[block].set(state.z)
    z = g.prox_only(av, hat)
    return state._replace(
        c=c, zb=zb, av=av, z=z, sweep=sweep, it=state.it + 1
    )


# ---------------------------------------------------------------------------
# LFinito (low-memory) variant
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def lfinito_init(F, g, x0, gamma, key, cfg: FinitoCfg) -> LFinitoState:
    """Reference Finito_LFinito.jl:39-74. Note the init state's z is a
    copy of av (no prox!) — solution(init) == av, a behavioral quirk the
    streaming API preserves."""
    N = cfg.N
    hat_gamma = 1.0 / jnp.sum(1.0 / gamma)
    av = x0 - (hat_gamma / N) * F.grad_sum_all(x0)
    sweep = init_sweep(key, N, cfg.batch, cfg.sweeping)
    return LFinitoState(
        gamma=gamma, hat_gamma=hat_gamma, av=av, z=av, z_full=av, sweep=sweep,
        it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _lfinito_step(F, g, cfg: FinitoCfg, state: LFinitoState) -> LFinitoState:
    """One epoch (reference Finito_LFinito.jl:77-103): full-gradient
    refresh of av at z_full, then a block sweep where each block's
    aggregate update is

        av += (hat_γ/N) Σ_B [∇f_i(z_full) - ∇f_i(z)] + hat_γ (Σ_B 1/γ_i)(z - z_full)

    — the bracketed sum is ``grad_sum_diff`` (a matmul pair for
    linear-gradient oracles)."""
    N, B = cfg.N, cfg.batch
    d = num_blocks(N, B)
    hat = state.hat_gamma

    z_full = g.prox_only(state.av, hat)
    av = z_full - (hat / N) * F.grad_sum_all(z_full)

    if cfg.sweeping == Sweep.SHUFFLED:
        key, sub = jax.random.split(state.sweep.key)
        order = jax.random.permutation(sub, d).astype(jnp.int32)
        sweep = state.sweep._replace(key=key, order=order)
    else:
        order = state.sweep.order  # natural order (cyclic; sweeping=1
        # degenerates to cyclic exactly as in the reference, :36,89)
        sweep = state.sweep

    lane = jnp.arange(B, dtype=jnp.int32)

    def block_body(carry, j):
        av, z = carry
        z = g.prox_only(av, hat)
        if N % B == 0:  # contiguous fast path (see _use_contiguous)
            start = j * B
            diff = F.grad_sum_diff_block(z_full, z, start, B)
            inv_g = jnp.sum(
                1.0 / jax.lax.dynamic_slice_in_dim(state.gamma, start, B)
            )
        else:
            idx = j * B + lane
            mask = idx < N
            idx = jnp.minimum(idx, N - 1)
            diff = F.grad_sum_diff(z_full, z, idx, mask)
            inv_g = jnp.sum(jnp.where(mask, 1.0 / state.gamma[idx], 0))
        av = av + (hat / N) * diff + hat * inv_g * (z - z_full)
        return (av, z), None

    (av, z), _ = jax.lax.scan(block_body, (av, state.z), order)
    return state._replace(av=av, z=z, z_full=z_full, sweep=sweep, it=state.it + 1)


# ---------------------------------------------------------------------------
# adaptive variant
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def finito_adaptive_init(F, g, x0, key, cfg: FinitoCfg) -> FinitoAdaptiveState:
    """Reference Finito_adaptive.jl:60-97: finite-difference probe of the
    smoothness moduli with doubling-perturbation retry, then the
    aggregate bootstrap with the gradient/value tables."""
    N = cfg.N
    rdt = real_dtype_of(x0)
    fi_x, G0 = F.value_and_grad_all(x0)                  # tables at x0
    s = jnp.broadcast_to(x0, G0.shape)

    # --- probe L_i ≈ ||∇f_i(x0 + δ) - ∇f_i(x0)|| / (t √n) / N -----------
    xeps = x0 + jnp.ones_like(x0)
    G1 = F.grad_all(xeps)
    nmg0 = jnp.sqrt(jnp.sum(jnp.abs(G1 - G0) ** 2, axis=1)).astype(rdt)
    eps = jnp.finfo(rdt).eps

    def need_retry(c):
        nmg, t, k = c
        return jnp.any(nmg < eps)

    def retry(c):
        # rows whose probe collapsed get a fresh ±t perturbation with t
        # doubled afterwards — the reference's while loop at :78-84,
        # including its quirk that the final L uses the post-doubled t.
        nmg, t, k = c
        k, sub = jax.random.split(k)
        signs = jax.random.rademacher(sub, G0.shape, dtype=rdt)
        xs = x0[None, :] + t[:, None] * signs.astype(x0.dtype)
        Gp = F.grad_pointwise(xs, jnp.arange(N))
        nmg_new = jnp.sqrt(jnp.sum(jnp.abs(Gp - G0) ** 2, axis=1)).astype(rdt)
        bad = nmg < eps
        return jnp.where(bad, nmg_new, nmg), jnp.where(bad, t * 2, t), k

    t0 = jnp.ones((N,), rdt)
    key, probe_key = jax.random.split(key)
    nmg, t_final, _ = jax.lax.while_loop(need_retry, retry, (nmg0, t0, probe_key))

    n_dim = x0.size
    L_int = nmg / (t_final * jnp.sqrt(jnp.asarray(float(n_dim), rdt))) / N
    gamma = cfg.alpha / L_int
    hat_gamma = 1.0 / jnp.sum(1.0 / gamma)
    av = hat_gamma * (
        jnp.sum(s / gamma[:, None], axis=0) - jnp.sum(G0, axis=0) / N
    )
    z = g.prox_only(av, hat_gamma)
    sweep = init_sweep(key, N, 1, cfg.sweeping)
    # adaptive cyclic starts at index 1 (state idxr init 0, :106-108)
    if cfg.sweeping == Sweep.CYCLIC:
        sweep = sweep._replace(pos=jnp.zeros((), jnp.int32))
    return FinitoAdaptiveState(
        s=s, gradf=G0, fi_x=fi_x, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z,
        sweep=sweep, it=jnp.ones((), jnp.int32), status=jnp.zeros((), jnp.int32),
    )


def _finito_adaptive_step(F, g, cfg: FinitoCfg, state: FinitoAdaptiveState):
    """Reference Finito_adaptive.jl:100-155: single-index selection,
    backtracking on the descent-lemma model with closed-form rescaling of
    (av, hat_γ), γ-underflow abort, then the table/average/prox update."""
    N = cfg.N
    rdt = state.gamma.dtype
    eps = jnp.finfo(rdt).eps

    idxv, _, sweep = next_block(state.sweep, N, 1, cfg.sweeping)
    i = idxv[0]
    s_i = state.s[i]
    gradf_i = state.gradf[i]
    fi_xi = state.fi_x[i]

    def sqnorm(v):
        return jnp.sum(jnp.abs(v) ** 2).astype(rdt)

    class Carry(NamedTuple):
        gi: jnp.ndarray
        hat: jnp.ndarray
        av: jnp.ndarray
        z: jnp.ndarray
        res: jnp.ndarray
        done: jnp.ndarray
        abort: jnp.ndarray

    def cond(c: Carry):
        return ~c.done

    def body(c: Carry):
        abort_now = c.gi < cfg.tol_b / N
        fi_z = F.value_i(c.z, i).astype(rdt)
        model = (
            fi_xi
            + jnp.real(jnp.vdot(gradf_i, c.res)).astype(rdt)
            + (0.5 * N * cfg.alpha / c.gi) * sqnorm(c.res)
        )
        tolv = 10 * eps * (1 + jnp.abs(fi_z))
        satisfied = fi_z <= model + tolv
        done = abort_now | satisfied
        # shrink branch (applied only when continuing)
        gi_new = c.gi * jnp.asarray(0.8, rdt)
        av1 = c.av / c.hat
        av1 = av1 + s_i / gi_new - s_i / c.gi
        hat_new = 1.0 / (1.0 / c.hat + 1.0 / gi_new - 1.0 / c.gi)
        av1 = av1 * hat_new
        z_new = g.prox_only(av1, hat_new)
        res_new = z_new - s_i
        keep = done

        def pick(a, b):
            return jnp.where(keep, a, b)

        return Carry(
            gi=pick(c.gi, gi_new),
            hat=pick(c.hat, hat_new),
            av=jnp.where(keep, c.av, av1),
            z=jnp.where(keep, c.z, z_new),
            res=jnp.where(keep, c.res, res_new),
            done=done,
            abort=c.abort | abort_now,
        )

    c0 = Carry(
        gi=state.gamma[i],
        hat=state.hat_gamma,
        av=state.av,
        z=state.z,
        res=state.z - s_i,
        done=jnp.zeros((), bool),
        abort=jnp.zeros((), bool),
    )
    c = jax.lax.while_loop(cond, body, c0)

    def aborted(_):
        return state._replace(
            sweep=sweep, status=jnp.asarray(Status.GAMMA_UNDERFLOW, jnp.int32)
        )

    def update(_):
        gamma = state.gamma.at[i].set(c.gi)
        hat = c.hat
        av = c.av + (hat / c.gi) * (c.z - s_i)
        s = state.s.at[i].set(c.z)
        av = av + (hat / N) * gradf_i
        fi_z, g_new = F.value_and_grad_i(c.z, i)
        fi_x = state.fi_x.at[i].set(fi_z.astype(rdt))
        gradf = state.gradf.at[i].set(g_new)
        av = av - (hat / N) * g_new
        z = g.prox_only(av, hat)
        return FinitoAdaptiveState(
            s=s, gradf=gradf, fi_x=fi_x, gamma=gamma, hat_gamma=hat, av=av, z=z,
            sweep=sweep, it=state.it + 1, status=state.status,
        )

    return jax.lax.cond(c.abort, aborted, update, None)


# ---------------------------------------------------------------------------
# scan drivers
# ---------------------------------------------------------------------------

def _guarded(step_fn):
    def step(F, g, cfg, state):
        return jax.lax.cond(
            state.status == Status.RUNNING,
            lambda s: step_fn(F, g, cfg, s),
            lambda s: s,
            state,
        )
    return step


_STEPS = {
    "basic": _finito_basic_step,
    "basic_coeff": _finito_coeff_step,
    "lfinito": _lfinito_step,
    "adaptive": _finito_adaptive_step,
}


@partial(jax.jit, static_argnames=("cfg", "variant", "steps"))
def finito_run(F, g, state, cfg: FinitoCfg, variant: str, steps: int):
    step = _guarded(_STEPS[variant])

    def body(s, _):
        with jax.named_scope(f"finito_{variant}_step"):
            return step(F, g, cfg, s), None

    return jax.lax.scan(body, state, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg", "variant"))
def finito_step(F, g, state, cfg: FinitoCfg, variant: str):
    return _STEPS[variant](F, g, cfg, state)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finito:
    """Finito/MISO solver facade (reference ``Finito.jl:32-64``).

    Keyword knobs mirror the reference: γ (scalar or per-index array),
    ``sweeping`` (1 random / 2 cyclic / 3 shuffled), ``LFinito``,
    ``adaptive``, ``minibatch=(flag, size)`` (the flag is dead in the
    reference — only the size is consulted, Finito.jl:89 — kept for API
    parity), ``maxit``, ``verbose``, ``freq``, ``α``, ``tol``, ``tol_b``.
    ``tol`` is declared-but-unused in the reference step (dead
    parameter), retained for parity. ``seed`` replaces Julia's global
    RNG with an explicit PRNG key.
    """

    gamma: Optional[object] = None
    sweeping: int = 1
    LFinito: bool = False
    adaptive: bool = False
    minibatch: Tuple[bool, int] = (False, 1)
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    tol: float = 1e-8
    tol_b: float = 1e-9
    table: str = "auto"  # "full" (N,n) | "coeff" (N,) | "auto" (coeff if rank-1)
    # Lipschitz-proportional block draws over the RANDOM sweep: blocks
    # drawn by sampling.systematic_block decide which anchors refresh; needs
    # sweeping=1, the coefficient table, L and N % batch == 0.
    # Per-index γ_i = αN/L_i are unchanged (Finito's fixed point is
    # schedule-independent — see FinitoCfg.importance).
    importance_sampling: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.importance_sampling:
            if self.sweeping != 1:
                raise ValueError(
                    "Finito importance_sampling replaces the RANDOM "
                    "sweep — set sweeping=1")
            if self.LFinito or self.adaptive:
                raise ValueError(
                    "Finito importance_sampling: basic variant only")
            if self.table == "full":
                raise ValueError(
                    "Finito importance_sampling needs the coefficient "
                    "table (table='auto' or 'coeff')")
        if self.gamma is not None:
            gmin = np.min(np.asarray(self.gamma))
            assert gmin > 0, "γ must be positive"
        assert self.maxit > 0
        assert self.tol > 0
        assert self.tol_b > 0
        assert self.freq > 0
        assert self.sweeping in (1, 2, 3)

    @property
    def _variant(self):
        if self.LFinito:
            return "lfinito"
        if self.adaptive:
            return "adaptive"
        return "basic"

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
        cfg = FinitoCfg(
            N=N,
            batch=self.minibatch[1],
            sweeping=self.sweeping,
            alpha=float(self.alpha),
            tol_b=float(self.tol_b),
        )
        key = jax.random.PRNGKey(self.seed)
        variant = self._variant
        if variant == "adaptive":
            init = lambda: finito_adaptive_init(F, g, x0, key, cfg)
        else:
            gamma = resolve_gamma_array(self.gamma, L, N, self.alpha, rdt)
            if variant == "basic":
                coeff_ok = (
                    (self.sweeping != Sweep.RANDOM
                     or self.importance_sampling)
                    and N % cfg.batch == 0
                    and getattr(F, "supports_coeff", False)
                )
                if self.table == "coeff" and not coeff_ok:
                    raise ValueError(
                        "Finito table='coeff' needs a rank-1 oracle and "
                        "cyclic/shuffled sweeping with N divisible by batch"
                    )
                if self.importance_sampling and not coeff_ok:
                    raise ValueError(
                        "Finito importance_sampling needs a rank-1 "
                        "oracle and N divisible by batch")
                qcum = None
                if self.importance_sampling:
                    if L is None:
                        raise ValueError(
                            "Finito importance_sampling: provide L")
                    if jnp.iscomplexobj(x0):
                        raise ValueError(
                            "Finito importance_sampling: real dtypes "
                            "only")
                    from ciao_tpu.sampling import systematic_schedule

                    qcum, _, _ = systematic_schedule(L, N, cfg.batch, rdt)
                    cfg = cfg._replace(importance=True)
                if self.table in ("auto", "coeff") and coeff_ok:
                    variant = "basic_coeff"
                    cfg_c = cfg
                    init = lambda: finito_coeff_init(
                        F, g, x0, gamma, key, cfg_c)._replace(qcum=qcum)
                else:
                    init = lambda: finito_basic_init(F, g, x0, gamma, key, cfg)
            else:
                init = lambda: lfinito_init(F, g, x0, gamma, key, cfg)
        return x0, F, g, cfg, init, variant

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init, variant = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return finito_run(F, g, state, cfg, variant, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.hat_gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init, variant = self._setup(x0, F, g, L, N)
        step = lambda s: finito_step(F, g, s, cfg, variant)
        it = SolverIterable(
            x0_orig, init, step,
            rebase_fn=lambda s: finito_rebase(F, g, s, cfg),
            can_abort=(variant == "adaptive"),
        )
        return it

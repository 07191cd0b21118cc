"""Shared solver machinery.

Reference architecture being mirrored (SURVEY.md §1): each solver family
is an (immutable config, mutable state, init-iterate, step-iterate)
quadruple driven by a take/halt loop (reference ``Finito.jl:118-128``).
Accelerator mapping:

  * init-iterate  -> jitted ``init(F, g, state0...)``; counts as
                     iteration #1 exactly like the reference (the first
                     ``Base.iterate`` call IS the first yielded state,
                     so ``maxit=1`` == init only; ``test_lasso.jl:188-192``).
  * step-iterate  -> jitted ``step`` under ``jax.lax.scan`` in chunks
                     (chunk = ``freq`` when verbose); a ``status`` flag in
                     the carry replaces the reference's return-``nothing``
                     early abort (Finito_adaptive.jl:123-125).
  * streaming     -> :class:`SolverIterable`, an infinite Python iterable
                     of states with zero-copy ``solution(state)`` views
                     (reference ``Finito.jl:186-234``).
"""

from __future__ import annotations

import enum
import warnings
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Status(enum.IntEnum):
    RUNNING = 0
    GAMMA_UNDERFLOW = 1  # adaptive backtracking abort (Finito_adaptive.jl:123-125)
    CONVERGED = 2        # tolerance met (PANOC/ZeroFPR ‖x−z‖/γ ≤ tol)


def solution(state):
    """Zero-copy view of the current solution — the only exported symbol
    of the reference (``Finito.jl:25``)."""
    return state.solution


def real_dtype_of(x) -> np.dtype:
    return np.zeros((), np.result_type(x)).real.dtype


def resolve_gamma_array(gamma, L, N, alpha, rdt, who="Finito"):
    """Per-index stepsizes γ_i.

    Mirrors ``Finito_basic.jl:61-74``: explicit γ (scalar or (N,)) wins;
    otherwise γ_i = α·N / L_i from the Lipschitz moduli (scalar L is
    broadcast). Missing both is the reference's ``@warn``-and-stop path.
    """
    if gamma is not None:
        g = jnp.asarray(gamma, rdt)
        return jnp.broadcast_to(g, (N,)) if g.ndim == 0 else g
    if L is None:
        raise ValueError(f"{who}: smoothness parameter absent — provide L or γ")
    Larr = jnp.broadcast_to(jnp.asarray(L, rdt), (N,))
    return alpha * N / Larr


def scalar_or_none(x, rdt):
    return None if x is None else jnp.asarray(x, rdt)


class SolverIterable:
    """Infinite state stream matching the reference's bare-iterable
    contract: ``iter.x0`` aliases the user's x0 (``test_lasso.jl:151``),
    the first state is the init state, iteration halts only on solver
    abort."""

    def __init__(self, x0, init_fn: Callable[[], Any], step_fn: Callable[[Any], Any],
                 rebase_fn: Callable[[Any], Any] | None = None,
                 can_abort: bool = False):
        self.x0 = x0
        self._init_fn = init_fn
        self._step_fn = step_fn
        # optional state-repair hook for resuming a state produced under
        # a DIFFERENT oracle row storage (checkpoint.resume_iterator's
        # ``rebase=True``): recomputes the delta-maintained running
        # average under THIS iterable's oracle (see saga.saga_rebase)
        self._rebase_fn = rebase_fn
        # Only solvers that can actually abort (adaptive Finito's
        # γ-underflow, Finito_adaptive.jl:123-125) pay the per-step
        # ``int(state.status)`` host readback, a device sync per
        # iterate; every other family streams asynchronously (status is
        # pinned to RUNNING by construction there).
        self._can_abort = can_abort

    def __iter__(self):
        state = self._init_fn()
        yield state
        if self._can_abort:
            while True:
                state = self._step_fn(state)
                if int(state.status) != Status.RUNNING:
                    # a CONVERGED state is the best iterate — yield it;
                    # an aborted one (γ underflow) is invalid — drop it,
                    # matching the reference's return-nothing abort
                    if int(state.status) == Status.CONVERGED:
                        yield state
                    return
                yield state
        else:
            # Backpressure WITHOUT a per-step sync. Each yielded step
            # is an async dispatch; a consumer that never materializes
            # values lets the inflight queue grow without bound, and on
            # the multi-device CPU backend that is FATAL: every queued
            # shard_map program holds 8 collective participants, and
            # XLA's in-process rendezvous (in_process_communicator.cc)
            # LOG(FATAL)s — silently — when a starved participant
            # misses its terminate timeout (core-dump diagnosis: abort
            # under absl LogMessage::SendToLog beneath
            # Rendezvous<AllGatherParticipant>). A sync every 16 steps
            # keeps ≤16 programs (~128 participants) in flight, which
            # survives heavy host load; its cost is one sync per 16
            # steps where the can_abort path pays one per step.
            k = 0
            while True:
                state = self._step_fn(state)
                k += 1
                if k % 16 == 0:
                    jax.block_until_ready(state)
                yield state


def take(iterable, k):
    """itertools.islice, named to match the reference's Base.Iterators.take."""
    import itertools

    return itertools.islice(iterable, k)


def loop(iterable):
    """Consume an iterable, returning its last element (the reference's
    ``IterationTools.loop``, used at ``test_logistic_l1.jl:121``)."""
    last = None
    for last in iterable:
        pass
    return last


def halt(iterable, stop):
    """Yield states until ``stop(state)`` is true, yielding the stopping
    state last (the reference's ``IterationTools.halt``; its solvers
    always pass ``stop ≡ false`` — ``Finito.jl:74`` — but the tool is
    part of the public iteration surface)."""
    for state in iterable:
        yield state
        if stop(state):
            return


def run_solver_loop(
    init_fn,
    run_chunk,
    maxit: int,
    verbose: bool,
    freq: int,
    disp: Callable[[int, Any], None],
    observe: Callable[[int, Any], None] = None,
):
    """Reference run loop (``Finito.jl:118-133``): init counts as
    iteration 1, then maxit-1 steps; progress printed every ``freq``.

    ``run_chunk(state, num_steps)`` must advance up to ``num_steps``
    steps (no-ops once aborted) and is expected to be jit-compiled.
    ``observe(it, state)``, when given, is called on the init state and
    then every ``freq`` iterations (and on the final state) — the
    monitoring hook the reference lacks (its main path computes NO
    convergence metric; ``Finito.jl:74``); pair it with
    :func:`ciao_tpu.monitor.observer`.
    Returns ``(final_state, num_iters)`` where num_iters counts yielded
    states (init + completed steps), matching the enumerate() count.
    """
    state = init_fn()
    it = 1
    if observe is not None:
        observe(it, state)
    remaining = maxit - 1
    chunk = freq if (verbose or observe is not None) else max(remaining, 1)
    while remaining > 0:
        n = min(chunk, remaining)
        state = run_chunk(state, n)
        remaining -= n
        done = int(state.it)  # states carry their own yield count
        if verbose and done % freq == 0:
            disp(done, state)
        if observe is not None:
            observe(done, state)
        it = done
        if int(state.status) != Status.RUNNING:
            break
    if verbose and it % freq != 0:
        disp(it, state)
    if int(state.status) == Status.GAMMA_UNDERFLOW:
        warnings.warn("parameter γ became too small — solver aborted early")
    return state, it


"""Staged-precision solving — the measured narrow-storage schedule as
a library API.

The recipe for deep targets on bandwidth-bound problems: run the early
epochs on int8- (or bf16-) stored oracle rows, which move a quarter
(half) of the f32 bytes per step, then SWITCH to f32 rows for the
finish — with a mandatory ``saga_rebase`` at every switch (the
delta-maintained running average otherwise keeps the old operator's
bias forever and the finish floors near the coarse storage's
quantization error; ``saga.saga_rebase`` has the numbers).

``staged_saga`` packages that schedule: it runs block SAGA in chunks,
watches the (full-pass) objective at chunk boundaries, and advances to
the next storage stage when progress per chunk plateaus — no knowledge
of f* required. The returned ``StagedInfo`` records the per-stage epoch
counts and objectives for observability.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class StagedInfo:
    """What the staged run did: one entry per stage."""

    storages: List[str]
    epochs: List[int]          # epochs spent in each stage
    objectives: List[float]    # objective at each stage's END
    switched_early: List[bool]  # True = plateau fired (vs budget cap)


def staged_saga(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    storages: Sequence[str] = ("int8", "f32"),
    batch: int = 4096,
    chunk_epochs: int = 64,
    plateau_rtol: float = 1e-3,
    max_epochs: int = 8192,
    gamma: Optional[float] = None,
    importance_sampling: bool = False,
    seed: int = 0,
    observe=None,
) -> Tuple[jnp.ndarray, StagedInfo]:
    """Solve ``min (1/N) Σ f_i + g`` by SAGA with a staged row-storage
    schedule.

    ``F`` is the FULL-PRECISION oracle (its ``with_storage`` produces
    the narrow stages); ``storages`` lists the stages coarsest-first
    ("int8"/"bf16"/"f32"). Each stage runs in ``chunk_epochs``-epoch
    chunks until the relative objective decrease per chunk falls
    under ``plateau_rtol`` (≈ the stage's resolution floor), then the
    state is REBASED under the next stage's oracle (``saga_rebase`` —
    the storage-switch requirement) and the run
    continues. The final stage also stops on plateau. Total budget:
    ``max_epochs`` epochs across all stages.

    ``observe`` (optional) is called as ``observe(z)`` with the current
    iterate after every chunk — progress/crossing instrumentation (its
    cost is the caller's; ``deep_solve`` threads it through).
    ``importance_sampling=True`` (needs ``L``) runs every stage with
    Lipschitz-proportional block draws.

    Returns ``(solution, StagedInfo)``.
    """
    from ciao_tpu.monitor import objective
    from ciao_tpu.prox import Zero
    from ciao_tpu.solvers.saga import SAGA, saga_rebase, saga_run

    if g is None:
        g = Zero()
    x0 = jnp.asarray(x0)
    if N is None:
        N = F.num_terms
    if N % batch != 0:
        # shrink to the largest divisor ≤ batch (block sampling needs
        # contiguous blocks tiling N)
        b = batch
        while N % b != 0:
            b -= 1
        batch = b

    oracles = []
    for s in storages:
        if s == "f32":
            oracles.append(F)
        else:
            oracles.append(F.with_storage(s))

    # one cfg serves every stage (the storage lives in the oracle); the
    # facade derives the table layout and kernel choice from the f32
    # oracle
    solver = SAGA(maxit=1, block_sampling=True, batch=batch,
                  gamma=gamma, seed=seed,
                  importance_sampling=importance_sampling)
    _, _, _, cfg, init = solver._setup(x0, F, g, L, N)
    state = init()

    steps_per_epoch = N // batch
    chunk = chunk_epochs * steps_per_epoch
    max_chunks = max(1, max_epochs // chunk_epochs)

    # full precision; ONE streaming value pass (never the (N, n)
    # gradient materialization `monitor.objective` would do — at the
    # 10M scale that is a 5 GB allocation per check). F and g are jit
    # ARGUMENTS, never closed over: a closed-over device array becomes a
    # multi-GB constant baked into the compiled program.
    @jax.jit
    def _obj_fn(F_, g_, z):
        if hasattr(F_, "value_sum_all"):
            return F_.value_sum_all(z) / F_.num_terms + g_.value(z)
        return objective(F_, g_, z)

    def _obj(z):
        return _obj_fn(F, g, z)

    info = StagedInfo(storages=list(storages), epochs=[], objectives=[],
                      switched_early=[])
    chunks_used = 0
    for si, F_stage in enumerate(oracles):
        if si:
            # storage switch: re-derive the running average from the
            # table under the NEW operator (PERF.md: without this the
            # finish floors at the coarse stage's quantization error)
            state = saga_rebase(F_stage, state, cfg)
        prev = float(_obj(state.z))
        stage_chunks = 0
        plateaued = False
        while chunks_used < max_chunks:
            state = saga_run(F_stage, g, state, cfg, chunk)
            cur = float(_obj(state.z))
            stage_chunks += 1
            chunks_used += 1
            if observe is not None:
                observe(state.z)
            if prev - cur < plateau_rtol * max(abs(prev), 1e-30):
                plateaued = True
                prev = cur
                break
            prev = cur
        info.epochs.append(stage_chunks * chunk_epochs)
        info.objectives.append(prev)
        info.switched_early.append(plateaued)
        if chunks_used >= max_chunks:
            break
    return state.z, info

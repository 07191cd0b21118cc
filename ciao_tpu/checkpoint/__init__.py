"""Checkpoint / resume.

The reference has no serialization, but its architecture is
checkpoint-shaped: all solver state is one struct yielded every
iteration (SURVEY.md §5, reference ``Finito.jl:169-183``). Here every
solver state is a NamedTuple pytree of device arrays, so checkpointing
is generic:

  * :func:`save` / :func:`load` — single-file npz round-trip of any
    solver state (works for every family; sharded arrays are gathered).
  * :func:`save_async` — orbax-backed async per-shard checkpointing for
    large HBM-resident tables (used by the large-scale harness).

Resume = ``iterator``-mode consumption from a restored state: pass the
restored state to ``resume_iterator`` and keep stepping.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any

import jax
import numpy as np


def save(path, state: Any) -> None:
    """Serialize a solver-state pytree to ``<path>`` (npz + treedef).

    PORTABILITY: the treedef sidecar is pickled, and jax treedefs are
    NOT stable across jax versions — npz checkpoints are same-
    environment-only. For version-portable / sharded checkpoints use
    :func:`save_async` (orbax), which stores structure portably.
    """
    path = Path(path)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with open(str(path) + ".treedef", "wb") as f:
        pickle.dump(treedef, f)


def load(path) -> Any:
    """Restore a solver-state pytree saved by :func:`save`."""
    path = Path(path)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    with open(str(path) + ".treedef", "rb") as f:
        treedef = pickle.load(f)
    return jax.tree_util.tree_unflatten(treedef, [jax.numpy.asarray(l) for l in leaves])


def save_async(path, state: Any):
    """Async checkpoint via orbax (per-shard, suitable for sharded
    (N, n) tables). Returns the manager — call ``.wait_until_finished()``
    before relying on durability."""
    import orbax.checkpoint as ocp

    path = Path(path).absolute()
    ckptr = ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler())
    ckptr.save(path, args=ocp.args.StandardSave(state), force=True)
    return ckptr


def load_orbax(path, like: Any) -> Any:
    """Restore an orbax checkpoint with ``like``'s structure AND
    shardings — which makes it the ELASTIC-recovery primitive: build
    ``like`` by initializing the solver on the SURVIVOR mesh (the
    global array shapes are mesh-independent) and orbax reshards the
    stored per-shard data to the new layout. Pinned by
    tests/test_parallel.py::test_elastic_restore_onto_smaller_mesh."""
    import orbax.checkpoint as ocp

    path = Path(path).absolute()
    ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler())
    return ckptr.restore(path, args=ocp.args.StandardRestore(like))


def resume_iterator(iterable, state, rebase: bool = False):
    """Continue a :class:`~ciao_tpu.solvers.base.SolverIterable` from a
    restored state: yields ``state``, then keeps stepping.

    Pass ``rebase=True`` when ``state`` was produced under a DIFFERENT
    oracle row storage than ``iterable``'s (the staged bf16/int8→f32
    precision schedules): the solver's delta-maintained running average
    otherwise keeps the old operator's bias forever and the run floors
    near the coarse storage's quantization error (measured in PERF.md;
    ``saga_rebase`` docstring has the mechanism). The rebase costs one
    pass over the data and is a no-op for state layouts that are
    storage-consistent by construction. Plain same-oracle resume should
    keep the default (bit-exact continuation)."""
    from ciao_tpu.solvers.base import Status

    if rebase:
        fn = getattr(iterable, "_rebase_fn", None)
        if fn is None:
            raise ValueError(
                "rebase=True but this iterable has no storage-rebase hook"
            )
        state = fn(state)
    yield state
    if getattr(iterable, "_can_abort", True):
        while True:
            state = iterable._step_fn(state)
            if int(state.status) != Status.RUNNING:
                return
            yield state
    else:
        # same policy as SolverIterable: no per-step status readback
        # for families that cannot abort (a device sync per iterate),
        # with periodic backpressure so the async dispatch queue stays
        # bounded
        import jax

        k = 0
        while True:
            state = iterable._step_fn(state)
            k += 1
            if k % 16 == 0:
                jax.block_until_ready(state)
            yield state

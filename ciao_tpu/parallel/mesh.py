"""Mesh / topology module.

The reference is single-process with no parallelism of any kind
(SURVEY.md §2.3; verified over its 22 files) — its "distribution" exists
only at the mathematical level, where the finite-sum index ``i`` and the
sharing-problem blocks are the natural partition axes.  This module is
therefore a first-class component with no reference counterpart: it maps
that mathematical partition onto an accelerator device mesh.

Design (jax.sharding / GSPMD, scaling-book recipe):

  * axis ``"data"``  — index blocks: the (N, n) gradient/iterate tables
    and the per-row oracle data (A rows, labels, diagonals, Lipschitz
    moduli) are sharded by their leading N axis; the aggregated averages
    (``av``, SVRG anchors, ProShI coupling sums) are ``psum`` collectives
    that XLA lays onto ICI.
  * axis ``"model"`` — optional coordinate sharding of x for very large
    n (prox kernels are elementwise, so TP-safe); not wired into the
    solver fast paths yet.

Multi-host: call :func:`jax.distributed.initialize` before building the
mesh; everything here only sees the global device list.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: Optional[int] = None,
    devices: Optional[Sequence[Any]] = None,
    axis: str = DATA_AXIS,
) -> Mesh:
    """A 1-D mesh over the data (index-block) axis.

    ``n_data`` defaults to every visible device. Device order follows
    ``jax.devices()`` — contiguous along ICI rings on real slices.
    """
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices)
    return Mesh(np.asarray(devices[:n_data]), (axis,))


def make_mesh_2d(n_data: int, n_model: int, devices=None) -> Mesh:
    """A ("data", "model") mesh for combined index-block × coordinate
    sharding."""
    if devices is None:
        devices = jax.devices()
    grid = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def _leading_dim(leaf) -> Optional[int]:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        shape = np.shape(leaf)
    return shape[0] if len(shape) >= 1 else None


def data_specs(obj, N: int, axis: str = DATA_AXIS):
    """Per-leaf PartitionSpec tree: leaves whose LEADING dim equals the
    term count N shard over ``axis``; everything else replicates.

    This is the single placement rule for finite-sum problems: oracle
    data stacked over i (A (N, n), y (N,), diag (N, n), ...) and solver
    tables (s (N, n), γ (N,)) all shard by index block; x-sized vectors
    and scalars replicate.

    Oracles can opt fields OUT of the shape rule by declaring a class
    attribute ``dp_replicated = ("field", ...)`` — needed when a
    replicated field's leading dim can collide with N (e.g. the hybrid
    sparse oracle's (D,) ``hot_cols`` when N happens to equal D).
    """
    repl = frozenset(getattr(obj, "dp_replicated", ()) or ())

    def spec(path, leaf):
        if repl and path:
            k = path[-1]
            name = getattr(k, "name", None)
            if name is None:
                name = getattr(k, "key", None)
            if name in repl:
                return P()
        shape = getattr(leaf, "shape", None)
        if shape is None:
            shape = np.shape(leaf)
        if len(shape) >= 1 and shape[0] == N:
            return P(axis, *([None] * (len(shape) - 1)))
        return P()

    return jax.tree_util.tree_map_with_path(spec, obj)


def replicated_specs(obj):
    return jax.tree_util.tree_map(lambda _: P(), obj)


def shard_finite_sum(F, mesh: Mesh, N: Optional[int] = None, axis: str = DATA_AXIS):
    """``device_put`` an oracle's stacked data arrays over the mesh's
    data axis (leaves with leading dim N), replicating the rest."""
    if N is None:
        N = F.num_terms
    specs = data_specs(F, N, axis)
    return jax.tree_util.tree_map(
        lambda leaf, s: jax.device_put(leaf, NamedSharding(mesh, s)), F, specs
    )


def put_specs(obj, mesh: Mesh, specs):
    """device_put a pytree according to a matching PartitionSpec tree."""
    return jax.tree_util.tree_map(
        lambda leaf, s: jax.device_put(leaf, NamedSharding(mesh, s)), obj, specs
    )

"""Proximable-term protocol.

The reference consumes its nonsmooth term only through
``prox(g, x, gamma) -> (y, g(y))`` / in-place ``prox!``
(e.g. reference ``src/algorithms/Finito/Finito_basic.jl:84,118``).

Here a prox operator is a pytree-registered dataclass with:

  * ``value(x)``          — g(x)
  * ``prox(x, gamma)``    — argmin_z g(z) + 1/(2 gamma) |z - x|^2,
                            returning ``(z, g(z))``
  * ``prox_only(x, gamma)`` — just z (the hot-loop entry; the reference's
                            ``prox!`` never uses the returned value either)
"""

from __future__ import annotations

import abc
import dataclasses

import jax
import jax.numpy as jnp

from ciao_tpu.oracles.base import register_oracle as register_prox  # same mechanism


def static_field(**kwargs):
    return dataclasses.field(metadata={"static": True}, **kwargs)


class ProxOperator(abc.ABC):
    #: True when prox_only acts coordinatewise — such operators are safe
    #: to apply on a COORDINATE-SHARDED x (tensor-parallel "model" axis)
    #: with no collective. Norm-coupled proxes (NormL2, IndBallL2,
    #: IndSimplex, NormNuclear) override to False.
    separable: bool = True

    @abc.abstractmethod
    def value(self, x: jax.Array) -> jax.Array:
        ...

    @abc.abstractmethod
    def prox_only(self, x: jax.Array, gamma) -> jax.Array:
        ...

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, self.value(z)

    def __call__(self, x):
        return self.value(x)


def _softsign(x):
    """sign(x) that handles complex inputs as x/|x| (0 -> 0)."""
    if jnp.iscomplexobj(x):
        mag = jnp.abs(x)
        return jnp.where(mag == 0, 0, x / jnp.where(mag == 0, 1, mag))
    return jnp.sign(x)

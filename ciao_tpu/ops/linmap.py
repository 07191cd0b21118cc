"""Linear maps for primal-dual composite terms ``h(Kx)``.

The reference's nonsmooth term is always applied to x directly
(``prox(g, x, γ)`` — `/root/reference/src/algorithms/Finito/
Finito_basic.jl:84`). Primal-dual splitting (solvers.primal_dual)
generalizes to g(x) + h(Kx) for a linear K whose presence under a norm
has no closed prox (total variation, analysis sparsity, fused lasso).
A map here is a pytree dataclass with

  * ``matvec(x) -> Kx``          ((m,) from (n,))
  * ``rmatvec(y) -> Kᵀy``        (adjoint; conjugate-transpose for
                                  complex dtypes)
  * ``out_dim(n) -> m``
  * ``opnorm_bound(n) -> float`` — an UPPER bound on ‖K‖₂ (used for
    the default stepsizes; a bound only costs slightly smaller steps,
    an underestimate breaks convergence)

All three concrete maps are XLA-fusable elementwise/matmul ops — no
gather/scatter.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ciao_tpu.oracles.base import register_oracle, static_field


@register_oracle
@dataclasses.dataclass(frozen=True)
class IdentityMap:
    """K = I — primal-dual degenerates to the plain composite form."""

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def out_dim(self, n):
        return n

    def opnorm_bound(self, n):
        return 1.0


@register_oracle
@dataclasses.dataclass(frozen=True)
class DenseMap:
    """K given as an explicit (m, n) matrix."""

    M: jnp.ndarray

    def matvec(self, x):
        return self.M @ x

    def rmatvec(self, y):
        return self.M.conj().T @ y

    def out_dim(self, n):
        return self.M.shape[0]

    def opnorm_bound(self, n):
        # exact spectral norm on host at setup time (the map is small
        # relative to the oracle data; stepsizes are static anyway)
        return float(np.linalg.norm(np.asarray(self.M), 2))


@register_oracle
@dataclasses.dataclass(frozen=True)
class FirstDifference:
    """K = D, (Dx)_i = x_{i+1} − x_i, shape (n−1, n) — ‖Dx‖₁ is 1-D
    total variation. The adjoint is the negative divergence."""

    def matvec(self, x):
        return x[1:] - x[:-1]

    def rmatvec(self, y):
        # Dᵀy: (Dᵀy)_0 = −y_0, (Dᵀy)_i = y_{i−1} − y_i, (Dᵀy)_{n−1} = y_{n−2}
        z = jnp.zeros(y.shape[0] + 1, y.dtype)
        z = z.at[:-1].add(-y)
        z = z.at[1:].add(y)
        return z

    def out_dim(self, n):
        return n - 1

    def opnorm_bound(self, n):
        return 2.0  # ‖D‖ = 2·sin(π(n−1)/(2n)) < 2


@register_oracle
@dataclasses.dataclass(frozen=True)
class FirstDifference2D:
    """K = [D_h; D_v] on an (H, W) image flattened row-major to
    (H·W,): the stacked horizontal and vertical first differences —
    ``‖Kx‖₁`` is ANISOTROPIC 2-D total variation, the classic
    Chambolle-Pock image model (denoise/deblur with blocky priors).
    Output is (H·(W−1) + (H−1)·W,), horizontal block first. The
    adjoint is the negative 2-D divergence. ‖K‖² = ‖D_hᵀD_h + D_vᵀD_v‖
    ≤ 4 + 4 = 8 (each 1-D difference contributes < 4), so the bound is
    √8 — the standard TV operator-norm constant.

    Reference anchor: none (the reference's g-prox interface cannot
    express h∘K at all); VPU stencil ops, no gather/scatter."""

    H: int = static_field()
    W: int = static_field()

    def matvec(self, x):
        im = x.reshape(self.H, self.W)
        dh = (im[:, 1:] - im[:, :-1]).reshape(-1)
        dv = (im[1:, :] - im[:-1, :]).reshape(-1)
        return jnp.concatenate([dh, dv])

    def rmatvec(self, y):
        mh = self.H * (self.W - 1)
        dh = y[:mh].reshape(self.H, self.W - 1)
        dv = y[mh:].reshape(self.H - 1, self.W)
        im = jnp.zeros((self.H, self.W), y.dtype)
        im = im.at[:, :-1].add(-dh)
        im = im.at[:, 1:].add(dh)
        im = im.at[:-1, :].add(-dv)
        im = im.at[1:, :].add(dv)
        return im.reshape(-1)

    def out_dim(self, n):
        assert n == self.H * self.W, (n, self.H, self.W)
        return self.H * (self.W - 1) + (self.H - 1) * self.W

    def opnorm_bound(self, n):
        return 2.8284271247461903  # √8


@register_oracle
@dataclasses.dataclass(frozen=True)
class GradientMap2D:
    """K = (∇_h, ∇_v) on an (H, W) image flattened row-major: FORWARD
    differences with Neumann boundary (last column/row of each field
    is 0), output (2·H·W,) — horizontal field first, each field in
    image layout. Pairing the two fields pixelwise under
    :class:`ciao_tpu.prox.NormL21` gives ISOTROPIC total variation
    (the standard Rudin-Osher-Fatemi discretization, rotation-fairer
    than the anisotropic stacked-ℓ1 of :class:`FirstDifference2D`);
    under NormL1 it is exactly the anisotropic model on padded fields.
    Adjoint = negative divergence with the matching boundary
    convention. ‖K‖² ≤ 8 as for any 2-point difference pair."""

    H: int = static_field()
    W: int = static_field()

    def matvec(self, x):
        im = x.reshape(self.H, self.W)
        dh = jnp.zeros_like(im).at[:, :-1].set(im[:, 1:] - im[:, :-1])
        dv = jnp.zeros_like(im).at[:-1, :].set(im[1:, :] - im[:-1, :])
        return jnp.concatenate([dh.reshape(-1), dv.reshape(-1)])

    def rmatvec(self, y):
        m = self.H * self.W
        dh = y[:m].reshape(self.H, self.W)
        dv = y[m:].reshape(self.H, self.W)
        im = jnp.zeros((self.H, self.W), y.dtype)
        im = im.at[:, :-1].add(-dh[:, :-1])
        im = im.at[:, 1:].add(dh[:, :-1])
        im = im.at[:-1, :].add(-dv[:-1, :])
        im = im.at[1:, :].add(dv[:-1, :])
        return im.reshape(-1)

    def out_dim(self, n):
        assert n == self.H * self.W, (n, self.H, self.W)
        return 2 * self.H * self.W

    def opnorm_bound(self, n):
        return 2.8284271247461903  # √8

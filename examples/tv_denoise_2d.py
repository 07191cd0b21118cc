"""2-D total-variation denoising — isotropic (ROF) vs anisotropic —
with Chambolle-Pock on one card.

The h(Kx) capability class in its classic image form: the quadratic
data term is the prox'd g (`SqrDistPoint`), the TV lives in the dual
through a stencil linear map. Isotropic TV pairs the horizontal and
vertical difference fields pixelwise under `GroupNormL21` (the
rotation-fair Rudin-Osher-Fatemi model); anisotropic stacks them under
a plain ℓ1.

    python examples/tv_denoise_2d.py          # 512×512
    python examples/tv_denoise_2d.py small    # CI smoke shape

Reference anchor: none (the prox-of-g-only reference cannot express
h∘K); the subdifferential certificate is exact for the denoising form.
"""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np

import ciao_tpu
from ciao_tpu import FirstDifference2D, GradientMap2D, GroupNormL21, NormL1
from ciao_tpu.prox import SqrDistPoint


def main(H=512, W=512, lam=0.3, maxit=4000, small=False):
    if small:  # CI smoke shapes (tests/test_examples.py)
        H, W, maxit = 32, 32, 2000
    n = H * W
    rng = np.random.default_rng(0)
    truth = np.zeros((H, W), np.float32)
    truth[: H // 2, :] = 1.5
    truth[H // 2:, W // 2:] = -1.0
    noisy = truth + 0.25 * rng.standard_normal((H, W)).astype(np.float32)
    b = jnp.asarray(noisy.reshape(-1))
    g = SqrDistPoint(b=b, rho=jnp.asarray(1.0))

    results = {}
    for tag, K, h in (
        ("isotropic", GradientMap2D(H=H, W=W),
         GroupNormL21(lam=jnp.asarray(lam), groups=2)),
        ("anisotropic", FirstDifference2D(H=H, W=W),
         NormL1(lam=jnp.asarray(lam))),
    ):
        x, _ = ciao_tpu.ChambollePock(maxit=maxit)(
            jnp.zeros(n, jnp.float32), g=g, h=h, K=K, N=1)
        img = np.asarray(x).reshape(H, W)
        err = np.linalg.norm(img - truth) / np.linalg.norm(truth)
        noise_err = np.linalg.norm(noisy - truth) / np.linalg.norm(truth)
        print(f"{tag:11s}: rel error {err:.3f} (noisy input {noise_err:.3f})")
        assert err < noise_err          # it denoised
        results[tag] = img
    # both models recover the blocky structure; the axis-aligned edges
    # of this phantom favor neither, so they agree closely
    gap = np.max(np.abs(results["isotropic"] - results["anisotropic"]))
    print(f"iso-vs-aniso max pixel gap: {gap:.3f}")
    return results


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main(small="small" in sys.argv[1:])

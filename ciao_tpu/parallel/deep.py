"""``deep_solve_dp`` — the deep-accuracy endgame over a device MESH.

The single-chip plan (:func:`ciao_tpu.deep_solve`: stochastic stage to
the f32 gradient floor → compensated-gradient FISTA polish) composed
from the DP building blocks:

1. **Stochastic stage** — :class:`DPSAGA` in LOCAL-UPDATE mode
   (``local_steps`` coefficient-SAGA steps per collective; the
   multi-chip throughput path), run in round chunks until the
   full-pass objective plateaus. The objective itself is one
   auto-sharded value pass over the row-sharded oracle.
2. **Curvature bound** — the same generic :func:`ciao_tpu.power_lmax`
   power iteration, evaluated directly on the SHARDED oracle: the
   margin matvec and back-projection auto-partition over the mesh
   (XLA inserts the psums), so no DP-specific code is needed.
3. **Polish stage** — :class:`DPForwardBackward` with
   ``polish_chunk``: each device accumulates its shard's gradient in
   compensated (two-sum) chunks and ONE x-sized psum combines them —
   the per-shard partial sums are already compensated, so the cross-
   device reduction of D ≈ 8-4096 values adds only ~√D·eps, orders
   below the chunk compensation it rides on.

Same accuracy contract as single-chip ``deep_solve`` (rel ≤ 1e-6 past
the monolithic-f32 floor — pinned on the 8-device CI mesh in
``tests/test_deep.py``), at DP throughput. f32 storage only (the
staged narrow-storage start is a single-chip feature for now).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from ciao_tpu.solvers.deep import DeepSolveInfo, _largest_divisor_leq
from ciao_tpu.solvers.polish import power_lmax
from ciao_tpu.solvers.staged import StagedInfo


def deep_solve_dp(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh=None,
    batch: int = 0,
    local_steps: int = 16,
    chunk_rounds: int = 64,
    plateau_rtol: float = 1e-5,
    max_rounds: int = 8192,
    gamma: Optional[float] = None,
    polish_steps: int = 16,
    polish_chunk: int = 32_768,
    power_iters: int = 6,
    eta_safety: float = 0.9,
    margin_slack: float = 0.0,
    seed: int = 0,
    observe=None,
) -> Tuple[jnp.ndarray, DeepSolveInfo]:
    """Solve ``min (1/N) Σ f_i + g`` to deep relative accuracy over a
    DP mesh. ``F`` must already be sharded (``shard_finite_sum``) with
    dense f32 rows; ``g`` needs ``prox_only``. ``local_steps`` sets the
    local steps per collective in the stochastic stage; the polish is
    ``polish_steps`` DP-FISTA passes with per-shard compensated chunks.
    Returns ``(x, DeepSolveInfo)`` (the ``staged`` record carries the
    stochastic stage's per-chunk objectives)."""
    from ciao_tpu.parallel.dp import DPSAGA, DPForwardBackward
    from ciao_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from ciao_tpu.prox import Zero

    if mesh is None:
        mesh = make_mesh()
    if N is None:
        N = F.num_terms
    if g is None:
        g = Zero()
    D = mesh.shape[DATA_AXIS]
    # global batch: must split evenly over the mesh AND tile each shard
    b = batch or min(4096, N // D * D)
    b = max(D, (b // D) * D)
    while (N // D) % (b // D):
        b -= D

    solver = DPSAGA(mesh=mesh, batch=b, block_sampling=True,
                    local_steps=local_steps, gamma=gamma, seed=seed)
    x0r, Fd, g, init, _, run, _ = solver._setup(x0, F, g, L, N)
    state = init()

    @jax.jit
    def _obj(F_, g_, z):
        return F_.value_sum_all(z) / N + g_.value(z)

    objs: List[float] = []
    chunks = 0
    prev = float(_obj(Fd, g, state.z))
    plateaued = False
    while chunks * chunk_rounds < max_rounds:
        state = run(state, chunk_rounds)
        cur = float(_obj(Fd, g, state.z))
        chunks += 1
        objs.append(cur)
        if observe is not None:
            observe(state.z)
        if prev - cur < plateau_rtol * max(abs(prev), 1e-30):
            plateaued = True
            prev = cur
            break
        prev = cur

    sinfo = StagedInfo(storages=["f32"],
                       epochs=[chunks * chunk_rounds * local_steps
                               * b // max(N, 1)],
                       objectives=objs or [prev],
                       switched_early=[plateaued])

    # curvature bound straight on the sharded oracle (auto-partitioned)
    key = jax.random.PRNGKey(seed + 1)
    lmax = float(power_lmax(Fd, state.z, key, iters=power_iters,
                            margin_slack=margin_slack))
    eta = eta_safety / lmax

    pchunk = _largest_divisor_leq(N // D, polish_chunk)
    pol = DPForwardBackward(mesh=mesh, maxit=polish_steps, fast=True,
                            gamma=eta, polish_chunk=pchunk)
    x, _ = pol(state.z, F=Fd, g=g)
    if observe is not None:
        observe(x)
    return x, DeepSolveInfo(staged=sinfo, lmax=lmax, eta=eta,
                            polish_steps=polish_steps, fp_res=[])


def deep_solve_tp(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh,
    batch: int = 0,
    chunk_steps: int = 2048,
    plateau_rtol: float = 1e-5,
    max_steps: int = 262_144,
    gamma: Optional[float] = None,
    polish_steps: int = 16,
    polish_chunk: int = 32_768,
    power_iters: int = 6,
    eta_safety: float = 0.9,
    margin_slack: float = 0.0,
    seed: int = 0,
    observe=None,
) -> Tuple[jnp.ndarray, DeepSolveInfo]:
    """The deep-accuracy plan on a ("data", "model") mesh — the
    TENSOR-PARALLEL face of :func:`ciao_tpu.deep_solve` (huge-n
    problems whose iterate itself shards over coordinates):

    1. TPSAGA in step chunks to the objective plateau (margins psum
       over "model", innovation psum over "data");
    2. the curvature bound from the same generic :func:`power_lmax`
       evaluated on the 2-D-sharded oracle (auto-partitioned jit);
    3. TP-FISTA polish with ``polish_chunk`` — each (data, model)
       shard's compensated chunked gradient, hi/lo carries psum'd
       separately over "data".

    ``F`` must be sharded with ``shard_finite_sum_2d`` (dense f32
    rows); ``g`` separable. Pinned to rel ≤ 1e-6 on the CI mesh in
    ``tests/test_deep.py``."""
    from ciao_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from ciao_tpu.parallel.tp import TPForwardBackward, TPSAGA
    from ciao_tpu.prox import Zero

    if MODEL_AXIS not in getattr(mesh, "shape", {}):
        raise ValueError("deep_solve_tp needs a ('data','model') mesh")
    if N is None:
        N = F.num_terms
    if g is None:
        g = Zero()
    D = mesh.shape[DATA_AXIS]
    b = batch or D

    solver = TPSAGA(mesh=mesh, batch=b, gamma=gamma, seed=seed)
    x0r, Fd, g, init, _, run, _ = solver._setup(x0, F, g, L, N)
    state = init()

    @jax.jit
    def _obj(F_, g_, z):
        return F_.value_sum_all(z) / N + g_.value(z)

    objs: List[float] = []
    chunks = 0
    prev = float(_obj(Fd, g, state.z))
    plateaued = False
    while chunks * chunk_steps < max_steps:
        state = run(state, chunk_steps)
        cur = float(_obj(Fd, g, state.z))
        chunks += 1
        objs.append(cur)
        if observe is not None:
            observe(state.z)
        if prev - cur < plateau_rtol * max(abs(prev), 1e-30):
            plateaued = True
            prev = cur
            break
        prev = cur

    sinfo = StagedInfo(
        storages=["f32"],
        epochs=[chunks * chunk_steps * b // max(N, 1)],
        objectives=objs or [prev], switched_early=[plateaued])

    key = jax.random.PRNGKey(seed + 1)
    lmax = float(power_lmax(Fd, state.z, key, iters=power_iters,
                            margin_slack=margin_slack))
    eta = eta_safety / lmax

    pchunk = _largest_divisor_leq(N // D, polish_chunk)
    pol = TPForwardBackward(mesh=mesh, maxit=polish_steps, fast=True,
                            gamma=eta, polish_chunk=pchunk)
    x, _ = pol(state.z, F=Fd, g=g)
    if observe is not None:
        observe(x)
    return x, DeepSolveInfo(staged=sinfo, lmax=lmax, eta=eta,
                            polish_steps=polish_steps, fp_res=[])


def deep_solve_pd_dp(
    x0,
    F,
    g=None,
    h=None,
    K=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh=None,
    tau: Optional[float] = None,
    sigma: Optional[float] = None,
    chunk_steps: int = 256,
    max_steps: int = 8192,
    refine_try_rtol: float = 3e-5,
    plateau_rtol: float = 5e-8,
    polish_chunk: int = 32_768,
    power_iters: int = 12,
    seed: int = 0,
):
    """The PRIMAL-DUAL deep route (:func:`ciao_tpu.deep_solve_pd`) over
    a DP mesh: :class:`DPCondatVu` with ``polish_chunk`` (per-shard
    compensated chunked gradient + ONE x-sized psum per step) at the
    spectral stepsize from :func:`power_lmax` ON the row-sharded oracle
    (auto-partitioned jit — the deep_solve_dp pattern), with the same
    early certified :func:`ciao_tpu.tv_refine` attempts once the
    replicated iterate settles. The refine passes (segment Gram, dual
    certificate) are plain jits over the sharded rows — XLA
    auto-partitions the chunk scan and inserts the reductions.

    ``F`` must already be sharded (``shard_finite_sum``) with dense f32
    rows. Returns ``(x, DeepPDInfo)``; on a failed certificate the
    unrefined replicated iterate is returned (``info.certified``)."""
    from ciao_tpu.ops.linmap import FirstDifference, IdentityMap
    from ciao_tpu.parallel.dp import DPCondatVu
    from ciao_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from ciao_tpu.prox import NormL1, Zero
    from ciao_tpu.solvers.deep_pd import DeepPDInfo, tv_refine

    if mesh is None:
        mesh = make_mesh()
    if N is None:
        N = F.num_terms
    D = mesh.shape[DATA_AXIS]
    x0j = jnp.asarray(x0)

    lam_hat = None
    if tau is None:
        # spectral τ on the SHARDED oracle; 1.2 margin — see
        # solvers.deep_pd (power iteration under-converges at the MP
        # edge; an overlarge τ oscillates and never identifies)
        lam_hat = 1.2 * float(power_lmax(
            F, x0j.astype(jnp.float32), jax.random.PRNGKey(seed),
            iters=power_iters))
        Kn = K if K is not None else IdentityMap()
        normK = float(Kn.opnorm_bound(x0j.shape[0]))
        sigma = 1.0 / max(normK, 1e-12) if sigma is None else sigma
        tau = 0.99 / (lam_hat / 2.0 + sigma * normK * normK)

    pchunk = _largest_divisor_leq(N // D, polish_chunk)
    solver = DPCondatVu(mesh=mesh, tau=tau, sigma=sigma,
                        polish_chunk=pchunk)
    x0r, Fd, ghk, init, _, run, _ = solver._setup(x0j, F, g, h, K, L, N)
    g_r, h_r, K_r = ghk
    state = init()

    from ciao_tpu.oracles import LeastSquaresRows

    tv_shape = (isinstance(Fd, LeastSquaresRows)
                and isinstance(g_r, Zero) and isinstance(h_r, NormL1)
                and isinstance(K_r, FirstDifference))
    gchunk = _largest_divisor_leq(N, polish_chunk)

    dx_rels: List[float] = []
    steps = 0
    info = DeepPDInfo(steps=0, dx_rels=dx_rels, lam_hat=lam_hat,
                      tau=float(tau), sigma=float(sigma))
    for _ in range(max(1, max_steps // chunk_steps)):
        x_prev = state.x
        state = run(state, chunk_steps)
        steps += chunk_steps
        info.steps = steps
        dx = float(jnp.linalg.norm(state.x - x_prev)
                   / jnp.maximum(jnp.linalg.norm(state.x), 1e-30))
        dx_rels.append(dx)
        if tv_shape and dx <= refine_try_rtol:
            d_np = jnp.abs(jnp.diff(state.x))
            n_jumps = int(jnp.sum(d_np > 1e-3 * jnp.max(d_np)))
            if 4 * n_jumps <= state.x.shape[0]:
                x_hat, certified, _ = tv_refine(
                    Fd, state.x, float(jnp.asarray(h_r.lam)),
                    chunk=gchunk)
                info.certified = certified
                if certified:
                    info.refined = True
                    return x_hat, info
        if dx <= plateau_rtol:
            break
    return state.x, info


def deep_solve_pd_tp(
    x0,
    F,
    g=None,
    h=None,
    K=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh,
    tau: Optional[float] = None,
    sigma: Optional[float] = None,
    chunk_steps: int = 256,
    max_steps: int = 8192,
    refine_try_rtol: float = 3e-5,
    plateau_rtol: float = 5e-8,
    refine_chunk: int = 32_768,
    power_iters: int = 12,
    seed: int = 0,
):
    """The PRIMAL-DUAL deep route on a ("data", "model") mesh —
    :class:`TPCondatVu` (stencil K, one scalar halo per neighbor per
    apply) run in chunks to IDENTIFICATION, then the certified
    :func:`ciao_tpu.tv_refine` / :func:`tv_refine3` reduced solve on
    the 2-D-sharded oracle (plain jits — XLA auto-partitions the
    segment-Gram scan and inserts the collectives). Identification
    does not need a compensated gradient (the reduced solve does the
    deep part — unlike the finite-sum plans, the stochastic stage's
    gradient noise never bounds the final accuracy here), so the plain
    TP step body is used as-is.

    ``F`` must be sharded with ``shard_finite_sum_2d`` (dense f32
    rows); ``g``/``h`` separable (the TPCondatVu contract). Returns
    ``(x, DeepPDInfo)``."""
    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.ops.linmap import FirstDifference, IdentityMap
    from ciao_tpu.parallel.mesh import MODEL_AXIS
    from ciao_tpu.parallel.tp import TPCondatVu
    from ciao_tpu.prox import NormL1, Zero
    from ciao_tpu.solvers.deep_pd import DeepPDInfo, tv_refine, tv_refine3

    if MODEL_AXIS not in getattr(mesh, "shape", {}):
        raise ValueError("deep_solve_pd_tp needs a ('data','model') mesh")
    if N is None:
        N = F.num_terms
    x0j = jnp.asarray(x0)

    lam_hat = None
    if tau is None:
        lam_hat = 1.2 * float(power_lmax(
            F, x0j.astype(jnp.float32), jax.random.PRNGKey(seed),
            iters=power_iters))
        Kn = K if K is not None else IdentityMap()
        normK = float(Kn.opnorm_bound(x0j.shape[0]))
        sigma = 1.0 / max(normK, 1e-12) if sigma is None else sigma
        tau = 0.99 / (lam_hat / 2.0 + sigma * normK * normK)

    solver = TPCondatVu(mesh=mesh, tau=tau, sigma=sigma)
    x0r, Fd, gh, init, _, run, _ = solver._setup(x0j, F, g, h, K, L, N)
    g_r, h_r = gh
    state = init()

    lsq = isinstance(Fd, LeastSquaresRows)
    fd_k = isinstance(K, FirstDifference)
    tv_shape = lsq and fd_k and isinstance(g_r, Zero) \
        and isinstance(h_r, NormL1)
    three_term = lsq and fd_k and isinstance(g_r, NormL1) \
        and isinstance(h_r, NormL1)
    gchunk = _largest_divisor_leq(N, refine_chunk)

    dx_rels: List[float] = []
    steps = 0
    info = DeepPDInfo(steps=0, dx_rels=dx_rels, lam_hat=lam_hat,
                      tau=float(tau), sigma=float(sigma))
    for _ in range(max(1, max_steps // chunk_steps)):
        x_prev = state.x
        state = run(state, chunk_steps)
        steps += chunk_steps
        info.steps = steps
        dx = float(jnp.linalg.norm(state.x - x_prev)
                   / jnp.maximum(jnp.linalg.norm(state.x), 1e-30))
        dx_rels.append(dx)
        if (tv_shape or three_term) and dx <= refine_try_rtol:
            d_np = jnp.abs(jnp.diff(state.x))
            n_jumps = int(jnp.sum(d_np > 1e-3 * jnp.max(d_np)))
            if 4 * n_jumps <= state.x.shape[0]:
                if three_term:
                    x_hat, certified = tv_refine3(
                        Fd, state.x, float(jnp.asarray(g_r.lam)),
                        float(jnp.asarray(h_r.lam)), chunk=gchunk)
                else:
                    x_hat, certified, _ = tv_refine(
                        Fd, state.x, float(jnp.asarray(h_r.lam)),
                        chunk=gchunk)
                info.certified = certified
                if certified:
                    info.refined = True
                    return x_hat, info
        if dx <= plateau_rtol:
            break
    return state.x, info

"""Multi-host data-parallel solve (template).

The reference is single-process (SURVEY.md §2.3); this is the ciao_tpu
recipe for several GPU hosts. Run ONE copy of this script per host with
CIAO_MULTIHOST=1 and the cluster named in the environment
(CIAO_COORDINATOR=host:port, CIAO_NUM_PROCESSES, CIAO_PROCESS_ID); JAX
wires the hosts into one global device mesh and the DP solvers keep all
cross-device traffic to one x-sized psum per step (NVLink within a
host, the network across hosts).

On a single host this script degrades gracefully to all local devices
(e.g. the 8-device virtual CPU mesh used in CI:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/multihost.py
).

The multi-PROCESS path this recipe rides (distributed init → global
mesh spanning processes → DP psum across the process boundary) is
executed in CI by ``tests/test_multihost.py``: 2 local processes ×
4 CPU devices, gloo collectives standing in for DCN, trajectory pinned
against the single-process 8-device run."""

import os

import jax

if os.environ.get("CIAO_MULTIHOST"):
    jax.distributed.initialize(
        coordinator_address=os.environ["CIAO_COORDINATOR"],
        num_processes=int(os.environ["CIAO_NUM_PROCESSES"]),
        process_id=int(os.environ["CIAO_PROCESS_ID"]),
    )

import jax.numpy as jnp  # noqa: E402

from ciao_tpu.oracles import LeastSquaresRows  # noqa: E402
from ciao_tpu.parallel import DPSAGA, make_mesh, shard_finite_sum  # noqa: E402
from ciao_tpu.prox import NormL1  # noqa: E402
from ciao_tpu.utils.problems import make_lasso  # noqa: E402


def main():
    D = len(jax.devices())                    # GLOBAL device count
    N, n = 128 * D, 64
    prob = make_lasso(N=N, n=n, p=8, seed=0)

    mesh = make_mesh()                        # all global devices on "data"
    F = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh,
    )
    g = NormL1(lam=jnp.asarray(prob.lam))

    solver = DPSAGA(mesh=mesh, batch=D * 8, block_sampling=True, maxit=30000)
    x, iters = solver(jnp.zeros(n), F=F, g=g, L=prob.L)

    if jax.process_index() == 0:
        gap = float(prob.cost(jax.device_get(x)) - prob.f_star)
        print(f"devices={D} hosts={jax.process_count()} "
              f"iters={iters} suboptimality={gap:.3e}")
        assert gap < 1e-4

    # Across-host recipe: amortize the collective with local-update
    # rounds — K local steps per round, ONE psum per round (the
    # per-step psum would cross the network every step). Same knobs exist for
    # every family (DPFinito(local_steps=K), DPFinito(LFinito=True,
    # local_sweep=True), DPSVRG(local_inner=True), DPProshi).
    solver = DPSAGA(mesh=mesh, batch=D * 8, block_sampling=True,
                    local_steps=64, rebase_every=50, maxit=500)
    x, steps = solver(jnp.zeros(n), F=F, g=g, L=prob.L)
    if jax.process_index() == 0:
        gap = float(prob.cost(jax.device_get(x)) - prob.f_star)
        print(f"local-update mode: {steps} steps in 500 rounds "
              f"(1 collective per 64 steps) suboptimality={gap:.3e}")
        assert gap < 1e-4


if __name__ == "__main__":
    from ciao_tpu.runtime import enable_compile_cache

    enable_compile_cache(__file__)
    main()

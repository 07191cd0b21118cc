"""Multi-HOST (multi-process) execution of the DP path.

The reference is strictly single-process (serial loop,
``Finito.jl:122-128``); SURVEY §2.3 names the communication backend —
``jax.distributed.initialize`` + a global mesh spanning processes — a
first-class component of this build. This test actually EXECUTES that
path: two local processes, each owning 4 virtual CPU devices, are wired
into one 8-device global mesh by ``jax.distributed`` (gloo collectives
standing in for DCN), run DPSAGA lockstep + local-update rounds across
the process boundary, and the trajectory must be BIT-EXACT equal to the
same solve on a single-process 8-device mesh — the schedules are
stateless (key, it, mesh-position) draws, so process layout must not
change the math.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.parallel import DPSAGA, make_mesh, shard_finite_sum
from ciao_tpu.prox import NormL1
from ciao_tpu.utils.problems import make_lasso

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """Launch 2 jax.distributed processes (4 CPU devices each) and
    collect process 0's solutions."""
    if len(jax.devices()) != 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    outdir = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = {
        "PATH": os.environ.get("PATH", ""),
        "HOME": os.environ.get("HOME", ""),
        "PYTHONPATH": os.pathsep.join(
            [os.path.dirname(os.path.dirname(__file__))]
            + os.environ.get("PYTHONPATH", "").split(os.pathsep)
        ),
        # env must be set BEFORE interpreter start: jax reads
        # JAX_PLATFORMS and XLA_FLAGS when it first initializes
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    }
    # worker output goes to FILES, not pipes: two mutually-blocking
    # distributed processes sharing PIPE capture can deadlock when one
    # fills its 64 KB pipe buffer mid-collective while the parent is
    # blocked draining the other
    logs = [open(outdir / f"worker{pid}.log", "wb") for pid in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid), "2", str(outdir)],
            env=env, stdout=logs[pid], stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    for p in procs:
        p.wait(timeout=600)
    for f in logs:
        f.close()
    for pid, p in enumerate(procs):
        out = (outdir / f"worker{pid}.log").read_text()
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    return np.load(outdir / "multihost_out.npz")


import functools


@functools.lru_cache(maxsize=1)
def _single_process_reference():
    """The identical problem/solves on THIS process's 8-device mesh
    (cached: both tests consume it, and it runs three full solves)."""
    D = 8
    N, n = 16 * D, 32
    prob = make_lasso(N=N, n=n, p=4, seed=0)
    mesh = make_mesh()
    F = shard_finite_sum(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh,
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    x0 = jnp.zeros(n)
    lock, _ = DPSAGA(mesh=mesh, batch=D, block_sampling=True, maxit=400)(
        x0, F=F, g=g, L=prob.L
    )
    loc, _ = DPSAGA(
        mesh=mesh, batch=D, block_sampling=True,
        local_steps=8, rebase_every=16, maxit=50,
    )(x0, F=F, g=g, L=prob.L)
    from ciao_tpu.parallel import TPSAGA, make_mesh_2d, shard_finite_sum_2d

    mesh2 = make_mesh_2d(D // 2, 2)
    F2 = shard_finite_sum_2d(
        LeastSquaresRows(
            A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
            scale=jnp.asarray(float(N)),
        ),
        mesh2,
    )
    tp, _ = TPSAGA(mesh=mesh2, batch=D, maxit=400)(x0, F=F2, g=g, L=prob.L)
    return np.asarray(lock), np.asarray(loc), np.asarray(tp), prob


def test_two_process_matches_single_process(two_process_run):
    """Lockstep DPSAGA across a real process boundary ≡ single-process
    8-device run. The schedules are stateless (key, it, mesh-position)
    draws so the MATH is identical; the only divergence allowed is
    collective reduction ORDER (gloo's cross-process all-reduce sums in
    a different association than single-process XLA's), i.e. O(eps)
    roundoff per psum — pinned here at 1e-12 relative over a 400-step
    f64 run (measured ~3e-14; a schedule or sharding bug shows up at
    O(1))."""
    lock, loc, tp, prob = _single_process_reference()
    np.testing.assert_allclose(
        two_process_run["lockstep"], lock, rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        two_process_run["local"], loc, rtol=1e-12, atol=1e-12
    )
    # TP on a (4, 2) GLOBAL mesh: the "model"-axis margin psum and the
    # "data"-axis innovation psum both crossed the process boundary
    np.testing.assert_allclose(
        two_process_run["tp"], tp, rtol=1e-12, atol=1e-12
    )


def test_two_process_gap_recorded(two_process_run):
    """The cross-process run made real progress (sanity that the psum
    carried actual gradient mass, not zeros)."""
    _, _, _, prob = _single_process_reference()
    x0_gap = prob.cost(np.zeros(32)) - prob.f_star
    assert 0 < float(two_process_run["gap"]) < 0.5 * x0_gap


def test_two_process_deep_solve_dp(two_process_run):
    """deep_solve_dp across the process boundary (round 4): the
    local-update stage's round collectives, the sharded-oracle power
    iteration and the polish's compensated psums all ran over gloo,
    and the result sits at deep relative accuracy."""
    rel = float(two_process_run["rel_deep"])
    assert rel <= 1e-6, rel

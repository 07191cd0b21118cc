"""Auxiliary-subsystem tests: checkpoint/resume, monitoring, sampling
schedules, and iteration tools (SURVEY.md §5 — the reference has none of
these as subsystems; these tests define our contracts)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import ciao_tpu
from ciao_tpu import checkpoint, monitor
from ciao_tpu.oracles import LeastSquaresRows
from ciao_tpu.prox import NormL1
from ciao_tpu.sampling import Sweep, init_sweep, next_block, next_block_id
from ciao_tpu.solvers.base import halt, loop, take
from ciao_tpu.utils.problems import make_lasso


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=16, n=4, p=2, seed=0)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A), b=jnp.asarray(prob.b), scale=jnp.asarray(16.0)
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    return prob, F, g


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, lasso):
    prob, F, g = lasso
    solver = ciao_tpu.SAGA(maxit=50)
    it = solver.iterator(jnp.zeros(4), F=F, g=g, L=prob.L)
    state = loop(take(iter(it), 20))
    checkpoint.save(tmp_path / "st.npz", state)
    restored = checkpoint.load(tmp_path / "st.npz")
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_continues_exactly(tmp_path, lasso):
    """Stopping at step k, checkpointing, and resuming must give the same
    trajectory as running straight through (deterministic PRNG carry)."""
    prob, F, g = lasso
    solver = ciao_tpu.SAGA(maxit=100)
    # straight-through run to 40 states
    st_full = loop(take(iter(solver.iterator(jnp.zeros(4), F=F, g=g, L=prob.L)), 40))
    # stop at 20, checkpoint, resume 20 more
    it1 = solver.iterator(jnp.zeros(4), F=F, g=g, L=prob.L)
    st_mid = loop(take(iter(it1), 20))
    checkpoint.save(tmp_path / "mid.npz", st_mid)
    restored = checkpoint.load(tmp_path / "mid.npz")
    it2 = solver.iterator(jnp.zeros(4), F=F, g=g, L=prob.L)
    resumed = loop(take(checkpoint.resume_iterator(it2, restored), 21))
    np.testing.assert_allclose(
        np.asarray(resumed.z), np.asarray(st_full.z), rtol=1e-12, atol=1e-14
    )
    assert int(resumed.it) == int(st_full.it)


def test_resume_iterator_rebase_storage_switch(lasso):
    """The staged-precision recipe (README): resume an int8-stage state
    under the f32 oracle with ``rebase=True`` — the hook must recompute
    the running average under the new rows (one ``apply_all`` pass).
    Every facade (single-chip, DP, TP) ships a hook; an iterable
    WITHOUT one (foreign/legacy) must raise rather than silently carry
    the old operator's bias."""
    prob, F, g = lasso
    solver = ciao_tpu.SAGA(maxit=100)
    Fq = F.with_storage("int8")
    st = loop(take(iter(solver.iterator(jnp.zeros(4), F=Fq, g=g, L=prob.L)), 30))
    it_f32 = solver.iterator(jnp.zeros(4), F=F, g=g, L=prob.L)
    first = next(checkpoint.resume_iterator(it_f32, st, rebase=True))
    np.testing.assert_allclose(
        np.asarray(first.av), np.asarray(F.apply_all(st.s) / 16),
        rtol=1e-12, atol=1e-14,
    )
    # the un-rebased resume keeps the int8-operator average verbatim
    first_nr = next(checkpoint.resume_iterator(it_f32, st))
    np.testing.assert_array_equal(np.asarray(first_nr.av), np.asarray(st.av))
    assert float(jnp.max(jnp.abs(first.av - st.av))) > 0

    class NoHook:
        pass

    with pytest.raises(ValueError, match="rebase"):
        next(checkpoint.resume_iterator(NoHook(), st, rebase=True))


# ---------------------------------------------------------------------------
# monitoring
# ---------------------------------------------------------------------------

def test_objective_and_residual(lasso):
    prob, F, g = lasso
    x, _ = ciao_tpu.SAGA(maxit=2000)(jnp.zeros(4), F=F, g=g, L=prob.L)
    obj = float(monitor.objective(F, g, jnp.asarray(x)))
    assert abs(obj - prob.cost(np.asarray(x))) < 1e-8
    # residual (gradient-scaled, ||Δz||/γ) is far smaller at the
    # optimum than at the cold start
    def res_at(x0):
        it = ciao_tpu.SAGA(maxit=10).iterator(jnp.asarray(x0), F=F, g=g, L=prob.L)
        states = list(take(iter(it), 2))
        return float(
            monitor.fixed_point_residual(states[0].z, states[1].z, states[0].gamma)
        )

    assert res_at(x) < res_at(np.zeros(4)) / 100


def test_trace_logging(tmp_path):
    tr = monitor.Trace()
    tr.log(1, obj=1.5)
    tr.log(2, obj=1.2, res=0.1)
    assert tr.last("obj") == 1.2
    tr.dump(tmp_path / "trace.jsonl")
    lines = (tmp_path / "trace.jsonl").read_text().strip().split("\n")
    assert len(lines) == 2


# ---------------------------------------------------------------------------
# sampling schedules
# ---------------------------------------------------------------------------

def test_cyclic_schedule_visits_all_blocks():
    st = init_sweep(jax.random.PRNGKey(0), 12, 3, Sweep.CYCLIC)
    seen = []
    for _ in range(4):
        blk, st = next_block_id(st, 12, 3, Sweep.CYCLIC)
        seen.append(int(blk))
    # cyclic starts at block 2 (reference idxr init; sampling docstring)
    assert sorted(seen) == [0, 1, 2, 3]


def test_shuffled_schedule_permutes_per_epoch():
    st = init_sweep(jax.random.PRNGKey(0), 32, 4, Sweep.SHUFFLED)
    epochs = []
    for _ in range(3):
        ep = []
        for _ in range(8):
            blk, st = next_block_id(st, 32, 4, Sweep.SHUFFLED)
            ep.append(int(blk))
        epochs.append(ep)
    for ep in epochs:
        assert sorted(ep) == list(range(8))
    # first epoch IS natural order (reference quirk: inds = 1:d only
    # reshuffled once an epoch is consumed, Finito_LFinito.jl:36,89),
    # later epochs shuffled
    assert epochs[0] == list(range(8))
    assert epochs[1] != sorted(epochs[1]) or epochs[2] != sorted(epochs[2])


def test_random_draw_without_replacement():
    st = init_sweep(jax.random.PRNGKey(0), 10, 4, Sweep.RANDOM)
    idx, mask, st = next_block(st, 10, 4, Sweep.RANDOM)
    assert len(set(np.asarray(idx).tolist())) == 4
    assert bool(np.all(np.asarray(mask)))


# ---------------------------------------------------------------------------
# iteration tools
# ---------------------------------------------------------------------------

def test_halt_stops_on_predicate(lasso):
    prob, F, g = lasso
    it = ciao_tpu.Finito(sweeping=2).iterator(jnp.zeros(4), F=F, g=g, L=prob.L)
    states = list(halt(take(iter(it), 100), lambda s: int(s.it) >= 5))
    assert int(states[-1].it) == 5
    assert len(states) == 5


def test_status_enum_surfaces_abort():
    """γ-underflow in adaptive Finito surfaces as a status, and the
    iterator stops (reference returns nothing + @warn,
    Finito_adaptive.jl:123-125)."""
    # a pathological oracle: huge curvature probe forces backtracking to
    # shrink γ below tol_b quickly
    prob = make_lasso(N=4, n=3, p=1, seed=1)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A * 1e8), b=jnp.asarray(prob.b), scale=jnp.asarray(4.0)
    )
    g = NormL1(lam=jnp.asarray(prob.lam))
    with pytest.warns(UserWarning, match="too small"):
        x, it = ciao_tpu.Finito(adaptive=True, maxit=2000, tol_b=1e30)(
            jnp.zeros(3), F=F, g=g
        )
    assert it < 2000


def test_observe_hook(lasso):
    """The facades' observe= hook fires on init and every freq steps,
    and monitor.observer logs decreasing objective + residual."""
    prob, F, g = lasso
    tr = monitor.Trace()
    x, it = ciao_tpu.SAGA(maxit=500, freq=100)(
        jnp.zeros(4), F=F, g=g, L=prob.L, observe=monitor.observer(F, g, tr)
    )
    its = [r["it"] for r in tr.records]
    assert its[0] == 1 and its[-1] == 500 and len(its) >= 5
    objs = [r["obj"] for r in tr.records]
    assert objs[-1] < objs[0]
    assert "residual" in tr.records[-1]
    # sanity: logged objective matches the external cost
    assert abs(objs[-1] - prob.cost(np.asarray(x))) < 1e-8


def test_checkpoint_async_orbax(tmp_path, lasso):
    """Orbax async per-shard checkpointing round-trips a solver state."""
    prob, F, g = lasso
    state = loop(take(iter(ciao_tpu.SAGA(maxit=30).iterator(
        jnp.zeros(4), F=F, g=g, L=prob.L)), 10))
    mgr = checkpoint.save_async(tmp_path / "ck", state)
    mgr.wait_until_finished()
    restored = checkpoint.load_orbax(tmp_path / "ck", state)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_staged_saga_reaches_f32_floor_with_switch():
    """staged_saga (the PERF.md int8→f32 production schedule as an
    API): the coarse stage plateaus, the switch rebases, and the f32
    finish reaches the same objective as a monolithic f32 run of the
    same total budget — with the stage bookkeeping recorded."""
    from ciao_tpu.solvers import staged_saga

    Np, npx = 2048, 128
    prob = make_lasso(N=Np, n=npx, p=8, seed=0, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(
        A=jnp.asarray(prob.A, jnp.float32),
        b=jnp.asarray(prob.b, jnp.float32),
        scale=jnp.asarray(float(Np), jnp.float32),
    )
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    x, info = staged_saga(
        jnp.zeros(npx, jnp.float32), F, g, L=prob.L,
        storages=("int8", "f32"), batch=128, chunk_epochs=32,
        plateau_rtol=1e-4, max_epochs=2048,
    )
    assert info.storages == ["int8", "f32"]
    assert len(info.epochs) == 2 and min(info.epochs) > 0
    assert info.switched_early[0]  # the int8 stage hit ITS floor
    # objective improved across the switch (the rebase unlocks it)
    assert info.objectives[1] < info.objectives[0]
    # reaches the reference tolerance band of a straight f32 run
    gap = float(prob.cost(np.asarray(x, np.float64)) - prob.f_star)
    rel = gap / abs(prob.f_star)
    assert rel < 1e-3

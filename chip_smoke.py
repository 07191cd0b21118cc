#!/usr/bin/env python
"""Smoke run of ciao_tpu's main paths on one NVIDIA GPU.

    python chip_smoke.py            # every one-card phase, on one card
    python chip_smoke.py --cards 4  # the data/tensor-parallel phase only

Phases, in order (each raises on the first wrong number; nothing is
caught, so any failure ends the run with a non-zero exit):

  device    refuse to run unless JAX's first device is a GPU
  saga      SAGA and staged int8→f32 SAGA to rel ≤ 1e-3 on a planted
            262,144 × 1,024 Lasso; ms/step, samples/s, step memory
  kernel    the Hopper SAGA block-step kernel against the plain step at
            Precision.HIGHEST, f32/bf16/int8 rows, at 262,144 × 1,024
            and 10,485,760 × 100; kernel and XLA step times in turns
  families  one short run of every public facade at 65,536 × 1,024
  deep      deep_solve to rel ≤ 1e-6 on the planted 10,485,760 × 100
            Lasso, and examples/deep_accuracy.py's main()
  multi     (--cards 4) DPSAGA, DPFinito, DPSVRG, deep_solve_dp and a
            2×2 TPSAGA on 1,048,576 × 1,024 rows sharded over 4 cards
            (SAGA to rel ≤ 1e-3 as on one card, deep_solve_dp to 1e-6)

Every number is printed beside the card's name and power limit. The
last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial

SAGA_SHAPE = (262_144, 1_024)
DEEP_SHAPE = (10 * 1024 * 1024, 100)
FAMILY_SHAPE = (65_536, 1_024)
MULTI_SHAPE = (1_048_576, 1_024)
BATCH = 4_096

CARD = "not available"


def report(phase: str, msg: str):
    print(f"[{phase}] {msg} | card: {CARD}", flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _lasso(N, n, p, seed=0):
    import jax.numpy as jnp

    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.prox import NormL1
    from ciao_tpu.utils.problems import make_lasso_device

    prob = make_lasso_device(N, n, p=min(p, n // 8), seed=seed)
    F = LeastSquaresRows(A=prob.A, b=prob.b,
                         scale=jnp.asarray(float(N), jnp.float32))
    g = NormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    return prob, F, g, jnp.zeros(n, jnp.float32)


def _block_gamma(A, b: int, iters: int = 30):
    """1/(3·max_j L_j), the SAGA step for components that are the
    contiguous ``b``-row blocks of ``A``: L_j = (N/b)·λ_max(A_jᵀA_j) by
    power iteration. A block-sampled step draws such components; one
    drawn as a union of aligned b-row blocks (a global block over
    several cards) has a modulus no larger than their largest."""
    import jax
    import jax.numpy as jnp

    HI = jax.lax.Precision.HIGHEST
    N, n = A.shape

    @jax.jit
    def lmax(A):
        Ab = A.reshape(N // b, b, n)

        def body(v, _):
            Av = jnp.einsum("dbn,dn->db", Ab, v, precision=HI)
            w = jnp.einsum("dbn,db->dn", Ab, Av, precision=HI)
            lam = jnp.linalg.norm(w, axis=1)
            return w / lam[:, None], lam

        v0 = jnp.ones((N // b, n), A.dtype)
        return jnp.max(jax.lax.scan(body, v0, None, length=iters)[1][-1])

    return 1.0 / (3.0 * float(lmax(A)) * N / b)


def _time(fn, *args, reps: int = 1):
    """Seconds per call of ``fn(*args)`` after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(count: int = 1):
    """The first device must be a GPU; returns the device list."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's devices are {devs[0].platform} "
            f"({len(devs)}); this smoke run needs an NVIDIA GPU")
    check(len(devs) >= count, f"{count} cards asked, {len(devs)} found")
    report("device", f"{devs[0].device_kind} x{len(devs)}")
    return devs


def phase_saga(shape=SAGA_SHAPE, batch=BATCH, max_epochs=8192, tol=1e-3):
    """SAGA and staged int8→f32 SAGA on the planted Lasso to rel ≤
    ``tol``; the facade's step time and the step's memory analysis.
    SAGA runs from the start with maxit doubling from 64 epochs until it
    reaches ``tol`` (the 64-epoch chunk compiles once)."""
    import jax

    from ciao_tpu import SAGA, staged_saga
    from ciao_tpu.solvers.saga import saga_run

    N, n = shape
    prob, F, g, x0 = _lasso(N, n, p=64)
    spe = N // batch
    epochs, rel = 32, float("inf")
    t0 = time.perf_counter()
    while rel > tol and epochs < max_epochs:
        epochs *= 2
        solver = SAGA(batch=batch, block_sampling=True,
                      maxit=epochs * spe + 1, freq=64 * spe)
        x, _ = solver(x0, F=F, g=g, L=prob.L, observe=lambda it, s: None)
        rel = prob.gap_rel(x)
    report("saga", f"SAGA {N}x{n} B={batch}: rel {rel:.3e} after {epochs} "
           f"epochs ({time.perf_counter() - t0:.2f} s for every try, "
           f"compile included)")
    check(rel <= tol, f"SAGA rel {rel:.3e} > {tol}")

    z, info = staged_saga(x0, F, g, L=prob.L, storages=("int8", "f32"),
                          batch=batch, chunk_epochs=64, plateau_rtol=1e-5,
                          max_epochs=max_epochs)
    rel = prob.gap_rel(z)
    report("saga", f"staged int8->f32: rel {rel:.3e}, epochs {info.epochs}")
    check(rel <= tol, f"staged SAGA rel {rel:.3e} > {tol}")

    _, F_, g_, cfg, init = solver._setup(x0, F, g, prob.L, None)
    state = init()
    for storage, Fs in (("f32", F_), ("int8", F_.with_storage("int8"))):
        run = jax.jit(lambda F, s: saga_run(F, g_, s, cfg, 64 * spe))
        dt = _time(run, Fs, state) / (64 * spe)
        report("saga", f"{storage} rows, kernel={cfg.kernel}: "
               f"{dt * 1e3:.4f} ms/step, {batch / dt:,.0f} samples/s")
        mem = jax.jit(lambda F, s: saga_run(F, g_, s, cfg, 1)).lower(
            Fs, state).compile().memory_analysis()
        report("saga", f"{storage} step memory: {mem}")


def _block_case(N, n, batch, storage, seed=0):
    import jax
    import jax.numpy as jnp

    from ciao_tpu.oracles import LeastSquaresRows

    kA, kb, kc, kz = jax.random.split(jax.random.PRNGKey(seed), 4)
    F = LeastSquaresRows(
        A=jax.random.normal(kA, (N, n), jnp.float32),
        b=jax.random.normal(kb, (N,), jnp.float32),
        scale=jnp.asarray(1.0, jnp.float32))
    if storage != "f32":
        F = F.with_storage(storage)
    c = jax.random.normal(kc, (N,), jnp.float32)
    z = jax.random.normal(kz, (n,), jnp.float32) / jnp.sqrt(n)
    start = jnp.int32(((N // batch) // 2) * batch)
    return F, c, z, start


def phase_kernel(shapes=(SAGA_SHAPE, DEEP_SHAPE), batch=BATCH,
                 storages=("f32", "bf16", "int8"), reps=200,
                 interpret=False):
    """One block step of the Hopper kernel against the plain XLA step
    at Precision.HIGHEST on the same rows (int8: the same quantized
    rows); f32 and int8 within 1e-5, bf16 within 1e-2, in norm. Then
    both steps timed in turns (xla, kernel, kernel, xla)."""
    import jax
    import jax.numpy as jnp

    from ciao_tpu.solvers.saga import coeff_block_xla
    from ciao_tpu.solvers.saga import coeff_block_kernel as _kernel

    def coeff_block_kernel(F, s, z, start, B):
        return _kernel(F, s, z, start, B, interpret=interpret)

    def rel(a, b):
        return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))

    kern = jax.jit(coeff_block_kernel, static_argnums=4)
    for N, n in shapes:
        for storage in storages:
            F, c, z, start = _block_case(N, n, batch, storage)
            with jax.default_matmul_precision("highest"):
                c_ref, i_ref = jax.jit(coeff_block_xla, static_argnums=4)(
                    F, c, z, start, batch)
            c_k, i_k = kern(F, c, z, start, batch)
            sl = slice(int(start), int(start) + batch)
            e_c, e_i = rel(c_k[sl], c_ref[sl]), rel(i_k, i_ref)
            tol = 1e-2 if storage == "bf16" else 1e-5
            report("kernel", f"{N}x{n} {storage}: rel err c {e_c:.2e}, "
                   f"innovation {e_i:.2e} (tol {tol:g})")
            check(e_c <= tol and e_i <= tol,
                  f"kernel vs reference {N}x{n} {storage}")
            check(bool(jnp.all(c_k[:int(start)] == c[:int(start)])),
                  "kernel wrote outside its block")

            def steps(step, F, c, z, start):
                # F is an argument, never closed over: a captured row
                # stack would be compiled in as a GB-sized constant
                def body(c, k):
                    s = (start + k * batch) % N
                    c, innov = step(F, c, z, s, batch)
                    return c, innov[0]
                return jax.lax.scan(body, c, jnp.arange(reps))

            t = {"xla": [], "kernel": []}
            runs = {"xla": jax.jit(partial(steps, coeff_block_xla)),
                    "kernel": jax.jit(partial(steps, coeff_block_kernel))}
            for name in ("xla", "kernel", "kernel", "xla"):
                t[name].append(_time(runs[name], F, c, z, start) / reps)
            tx, tk = (sum(v) / 2 for v in (t["xla"], t["kernel"]))
            report("kernel", f"{N}x{n} {storage} B={batch}: kernel "
                   f"{tk * 1e6:.2f} us/step, XLA {tx * 1e6:.2f} us/step "
                   f"(x{tx / tk:.2f})")


def _families(N, n, batch):
    """(name, run) for every public facade; run(prob, F, g, x0, L)
    returns the solution."""
    import ciao_tpu as ct
    from ciao_tpu.prox import IndBox

    spe = N // batch
    blk = dict(batch=batch, block_sampling=True)

    def svrg_gamma(L):
        import numpy as np

        return float(1.0 / (4.0 * np.max(np.asarray(L))))

    def box(prob):
        import numpy as np

        return IndBox(lo=-float(np.max(np.abs(np.asarray(prob.x_star)))),
                      hi=float(np.max(np.abs(np.asarray(prob.x_star)))))

    return [
        *[(f"Finito(sweeping={s})",
           lambda p, F, g, x0, L, s=s: ct.Finito(
               sweeping=s, minibatch=(True, batch), maxit=8 * spe)(
                   x0, F=F, g=g, L=L)[0]) for s in (1, 2, 3)],
        ("Finito(LFinito)", lambda p, F, g, x0, L: ct.Finito(
            LFinito=True, sweeping=2, minibatch=(True, batch), maxit=4)(
                x0, F=F, g=g, L=L)[0]),
        ("Finito(adaptive)", lambda p, F, g, x0, L: ct.Finito(
            adaptive=True, sweeping=2, minibatch=(True, batch),
            maxit=4 * spe)(x0, F=F, g=g, L=L)[0]),
        ("SVRG", lambda p, F, g, x0, L: ct.SVRG(
            maxit=4, m=spe, gamma=svrg_gamma(L), **blk)(
                x0, F=F, g=g, L=L)[0]),
        ("SVRG++", lambda p, F, g, x0, L: ct.SVRG(
            maxit=4, plus=True, m=spe // 4, gamma=svrg_gamma(L), **blk)(
                x0, F=F, g=g, L=L)[0]),
        ("Katyusha", lambda p, F, g, x0, L: ct.Katyusha(maxit=4, **blk)(
            x0, F=F, g=g, L=L)[0]),
        ("L-SVRG", lambda p, F, g, x0, L: ct.LSVRG(maxit=4 * spe, **blk)(
            x0, F=F, g=g, L=L)[0]),
        ("L-Katyusha", lambda p, F, g, x0, L: ct.LKatyusha(
            maxit=4 * spe, **blk)(x0, F=F, g=g, L=L)[0]),
        ("SARAH", lambda p, F, g, x0, L: ct.SARAH(maxit=4, **blk)(
            x0, F=F, g=g, L=L)[0]),
        # Point-SAGA has no separate g: it minimizes the smooth part
        ("Point-SAGA", lambda p, F, g, x0, L: ct.PointSAGA(
            maxit=8 * spe, **blk)(x0, F=F, L=L)[0]),
        ("SSNM", lambda p, F, g, x0, L: ct.SSNM(
            maxit=8 * spe, batch=batch)(x0, F=F, g=g, L=L)[0]),
        ("FISTA", lambda p, F, g, x0, L: ct.FISTA(maxit=50)(
            x0, F=F, g=g, L=L)[0]),
        ("PANOC", lambda p, F, g, x0, L: ct.PANOC(maxit=20)(
            x0, F=F, g=g, L=L)[0]),
        ("ZeroFPR", lambda p, F, g, x0, L: ct.ZeroFPR(maxit=20)(
            x0, F=F, g=g, L=L)[0]),
        ("DavisYin", lambda p, F, g, x0, L: ct.DavisYin(maxit=50)(
            x0, F=F, g=g, h=box(p), L=L)[0]),
        ("CondatVu", lambda p, F, g, x0, L: ct.CondatVu(maxit=50)(
            x0, F=F, g=g, h=box(p), L=L)[0]),
    ]


def phase_families(shape=FAMILY_SHAPE, batch=BATCH, sharing_shape=None):
    """One short run of every public facade: a finite objective below
    the start's. ProShI runs on the planted sharing problem."""
    import jax.numpy as jnp
    import numpy as np

    from ciao_tpu import Proshi
    from ciao_tpu.oracles import DiagQuadratic
    from ciao_tpu.prox import NormL1
    from ciao_tpu.utils.problems import make_sharing_planted

    N, n = shape
    prob, F, g, x0 = _lasso(N, n, p=64)
    rel0 = prob.gap_rel(x0)
    for name, run in _families(N, n, batch):
        t0 = time.perf_counter()
        rel = prob.gap_rel(run(prob, F, g, x0, prob.L))
        report("families", f"{name}: rel gap {rel0:.3e} -> {rel:.3e} "
               f"({time.perf_counter() - t0:.2f} s with compile)")
        check(np.isfinite(rel) and rel < rel0, f"{name} did not descend")

    Ns, ns = sharing_shape or shape
    sp = make_sharing_planted(N=Ns, n=ns, seed=0)
    Fs = DiagQuadratic(d=jnp.asarray(sp.d, jnp.float32),
                       q=jnp.asarray(sp.q, jnp.float32))
    gs = NormL1(lam=jnp.asarray(sp.lam, jnp.float32))
    t0 = time.perf_counter()
    x, _ = Proshi(maxit=8 * (Ns // batch), sweeping=2,
                  minibatch=(True, batch))(
        jnp.zeros(ns, jnp.float32), F=Fs, g=gs, L=sp.L, N=Ns)
    start = (sp.cost(np.zeros((Ns, ns))) - sp.f_star) / abs(sp.f_star)
    rel = (sp.cost(np.asarray(x)) - sp.f_star) / abs(sp.f_star)
    report("families", f"ProShI {Ns}x{ns}: rel gap {start:.3e} -> "
           f"{rel:.3e} ({time.perf_counter() - t0:.2f} s with compile)")
    check(np.isfinite(rel) and rel < start, "ProShI did not descend")


def phase_deep(shape=DEEP_SHAPE, batch=8_192, tol=1e-6, example=True):
    """deep_solve to rel ≤ ``tol`` on the planted Lasso, then
    examples/deep_accuracy.py's main() (1M×128, asserts rel ≤ 1e-6)."""
    import importlib.util
    import pathlib

    from ciao_tpu import deep_solve

    N, n = shape
    prob, F, g, x0 = _lasso(N, n, p=8)
    t0 = time.perf_counter()
    z, info = deep_solve(x0, F, g, L=prob.L, batch=batch, chunk_epochs=16,
                         plateau_rtol=1e-5, max_epochs=256)
    rel = prob.gap_rel(z)
    report("deep", f"deep_solve {N}x{n}: rel {rel:.3e} in "
           f"{time.perf_counter() - t0:.2f} s with compile "
           f"({sum(info.staged.epochs)} SAGA epochs + "
           f"{info.polish_steps} polish steps)")
    check(rel <= tol, f"deep_solve rel {rel:.3e} > {tol}")
    if example:
        path = pathlib.Path(__file__).resolve().parent / "examples" / \
            "deep_accuracy.py"
        spec = importlib.util.spec_from_file_location("deep_accuracy", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        rel = mod.main()
        report("deep", f"examples/deep_accuracy.py: rel {rel:.3e} in "
               f"{time.perf_counter() - t0:.2f} s")


def phase_multi(shape=MULTI_SHAPE, batch=4 * BATCH, cards=4, tol=1e-3):
    """The data- and tensor-parallel facades on rows sharded over
    ``cards`` devices, each against the planted optimum at the one-card
    tolerances: the SAGA runs to rel ≤ ``tol``, deep_solve_dp to 1e-6,
    Finito and SVRG a falling, finite objective as in the families
    phase. The global batch is ``cards`` × the one-card block, so each
    card steps through blocks of the one-card phase's size.

    The SAGA runs take the step of the block components they sample
    (``_block_gamma``), not the facade's per-row 1/(3·L_max): that
    step shrinks as 1/N, and at this N its f32 update falls below half
    an ulp of the iterate, which then freezes at rel 3.0e-3–3.4e-3 on
    one card as on four (PERF.md)."""
    import jax
    import numpy as np

    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.parallel import (
        DPFinito, DPSAGA, DPSVRG, TPSAGA, deep_solve_dp, make_mesh,
        make_mesh_2d, shard_finite_sum, shard_finite_sum_2d,
    )

    N, n = shape
    prob, F, g, x0 = _lasso(N, n, p=64)
    mesh = make_mesh(cards)
    Fd = shard_finite_sum(F, mesh)
    check(len(Fd.A.sharding.device_set) == cards,
          f"rows sit on {len(Fd.A.sharding.device_set)} devices")
    report("multi", f"rows {Fd.A.shape} on {cards} devices: "
           f"{Fd.A.sharding}")
    spe = N // batch
    gamma = _block_gamma(prob.A, batch // cards)

    rel0 = prob.gap_rel(x0)

    def solve(name, fn, tol=tol):
        """Run ``fn``; rel ≤ ``tol``, or (tol None, as for the families
        phase on one card) a finite objective below the start's."""
        t0 = time.perf_counter()
        x = fn()
        rel = prob.gap_rel(jax.device_get(x))
        report("multi", f"{name}: rel gap {rel0:.3e} -> {rel:.3e} "
               f"({time.perf_counter() - t0:.2f} s with compile)")
        if tol is None:
            check(np.isfinite(rel) and rel < rel0, f"{name} did not descend")
        else:
            check(rel <= tol, f"{name} rel {rel:.3e} > {tol}")

    blk = dict(mesh=mesh, batch=batch, block_sampling=True)
    solve("DPSAGA lockstep", lambda: DPSAGA(
        gamma=gamma, maxit=256 * spe, **blk)(x0, F=Fd, g=g, L=prob.L)[0])
    solve("DPSAGA local_steps=64", lambda: DPSAGA(
        gamma=gamma, local_steps=64, rebase_every=8, maxit=32 * spe, **blk)(
            x0, F=Fd, g=g, L=prob.L)[0])
    solve("DPFinito", lambda: DPFinito(
        mesh=mesh, batch=batch, sweeping=2, maxit=8 * spe)(
            x0, F=Fd, g=g, L=prob.L)[0], tol=None)
    solve("DPSVRG(local_inner)", lambda: DPSVRG(
        local_inner=True, maxit=4, m=spe // cards,
        gamma=float(1.0 / (4.0 * np.max(np.asarray(prob.L)))), **blk)(
            x0, F=Fd, g=g, L=prob.L)[0], tol=None)
    solve("deep_solve_dp", lambda: deep_solve_dp(
        x0, Fd, g, mesh=mesh, L=prob.L, batch=batch)[0], tol=1e-6)
    mesh2 = make_mesh_2d(2, 2)
    F2 = shard_finite_sum_2d(F, mesh2)
    check(len(F2.A.sharding.device_set) == cards, "2x2 mesh placement")
    solve("TPSAGA 2x2", lambda: TPSAGA(
        mesh=mesh2, batch=batch, gamma=gamma, maxit=256 * spe)(
            x0, F=F2, g=g, L=prob.L)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of ciao_tpu on NVIDIA GPUs.")
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 runs the multi-card phase only")
    args = ap.parse_args(argv)

    import jax

    from ciao_tpu import runtime

    global CARD
    runtime.enable_compile_cache(__file__)
    CARD = runtime.card_name_and_power_limit()
    devs = phase_device(args.cards)
    print(CARD, flush=True)
    if args.cards == 4:
        phase_multi(cards=4)
    else:
        for name, phase in (("saga", phase_saga), ("kernel", phase_kernel),
                            ("families", phase_families),
                            ("deep", phase_deep)):
            t0 = time.perf_counter()
            phase()
            report(name, f"phase done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of tpu_gpad on a CUDA GPU: the main paths at full width.

    python chip_smoke.py              # one GPU, phases (a)-(g)
    python chip_smoke.py --multi-gpu  # four GPUs of one host, sharded fleets only

Phases (one GPU):

(a) device: JAX's first device must be a GPU (no CPU fallback); prints the
    card's name and power limit from nvidia-smi.
(b) headline fleet: battery n=3 N=10, B=4096, 100 iterations, fp32
    "highest", through ``solve_batch`` with engine="auto"; u* within 1e-4
    of the NumPy oracle on 64 scenarios.
(c) reference flagship: battery 30x30 (n_z=900, m=3660), B=256, 100
    iterations; u* within 1e-4 of the oracle on 8 scenarios (the CPU
    test's tolerance). Then eps mode with restart: every scenario
    converged at eps=2e-5; the count at eps=1e-5 is printed (fp32 floors a
    few scenarios' residual just above 1e-5 at this shape).
(d) served loop: ``closed_loop.Controller`` on the headline problem
    (100 iterations with adaptive restart), warm-started, 20 samples of
    the battery plant; each move matches a cold solve of the same state
    within 1e-4.
(e) past the condensation wall: battery n30 N200 B64 through
    ``stagewise.auto_solver`` (finite, feasible to 1e-3 after an eps
    solve), and parity with the condensed engine at battery n8 N60.
(f) fused dual kernel: compiled for the card (never interpreted), checked
    against the XLA dual loop and the oracle at the headline width, both
    times printed.
(g) the card-only tests (``pytest -m gpu`` on ``tests/test_dual_kernel.py``).

``--multi-gpu`` runs only the sharded path: a (4x1) data-parallel mesh and
a (2x2) data x model mesh, each against single-card ``solve_batch`` and
the oracle.

One process owns the card(s); nothing here starts a second JAX process.
Exits non-zero on any failure; the last stdout line is then never the
``{"ok": true, ...}`` result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n=20):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return 1e3 * ts[len(ts) // 2]


class Smoke:
    """The phases; the defaults are the full-width shapes above."""

    def __init__(self, B_head=4096, B_flag=256, flag=(30, 30), sw=(30, 200, 64)):
        import jax
        import numpy as np

        self.jax, self.np = jax, np
        self.B_head, self.B_flag = B_head, B_flag
        self.flag = flag  # (n_cells, horizon) of the flagship
        self.sw = sw  # (n_cells, horizon, batch) of the stage-wise fleet

    def oracle_err(self, qp, X, u, iters, n, **kw):
        from tpu_gpad.solver.reference import gpad_solve_qp

        np = self.np
        return max(
            float(np.abs(np.asarray(u[i]) - gpad_solve_qp(
                qp, np.asarray(X[i], np.float64), iterations=iters, **kw).u).max())
            for i in range(min(n, X.shape[0])))

    def batch(self, n_x, B, seed=0):
        np = self.np
        rng = np.random.default_rng(seed)
        return self.jax.numpy.asarray(
            rng.uniform(-0.5, 0.5, (B, n_x)).astype(np.float32))

    def phase_b(self):
        import tpu_gpad
        from tpu_gpad import problems
        from tpu_gpad.solver import SolverConfig, solve_batch
        from tpu_gpad.solver.core import resolve_engine, resolve_form

        qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=10))
        data = tpu_gpad.dualize(qp, iterations=100, paired="auto")
        X = self.batch(3, self.B_head)
        cfg = SolverConfig(iterations=100)
        res = solve_batch(data, X, config=cfg)
        u = self.np.asarray(res.u)
        assert u.shape == (self.B_head, qp.n_u) and self.np.isfinite(u).all()
        err = self.oracle_err(qp, X, u, 100, 64)
        log(f"(b) headline n_z={data.n_z} m={data.m} m_half={data.m_half} "
            f"B={self.B_head}: engine={resolve_engine(data, cfg)} "
            f"form={resolve_form(data, cfg)} u* err vs oracle (64) {err:.3e} "
            f"(limit 1e-4)")
        assert err <= 1e-4, err
        self.head = (qp, data, X)

    def phase_c(self):
        import tpu_gpad
        from tpu_gpad import problems
        from tpu_gpad.solver import SolverConfig, solve_batch
        from tpu_gpad.solver.core import resolve_engine, resolve_form

        n, N = self.flag
        qp = tpu_gpad.condense(problems.battery(n_cells=n, horizon=N))
        data = tpu_gpad.dualize(qp, iterations=1000, paired="auto")
        X = self.batch(n, self.B_flag)
        cfg = SolverConfig(iterations=100)
        u = self.np.asarray(solve_batch(data, X, config=cfg).u)
        assert self.np.isfinite(u).all()
        err = self.oracle_err(qp, X, u, 100, 8)
        log(f"(c) flagship battery {n}x{N} n_z={data.n_z} m={data.m} "
            f"B={self.B_flag}: engine={resolve_engine(data, cfg)} "
            f"form={resolve_form(data, cfg)} u* err vs oracle (8) {err:.3e} "
            f"(limit 1e-4)")
        assert err <= 1e-4, err
        conv = {}
        for eps in (1e-5, 2e-5):
            ce = SolverConfig(mode="eps", eps_g=eps, eps_V=eps, iterations=1000,
                              restart=True)
            r = solve_batch(data, X, config=ce)
            conv[eps] = int(self.np.asarray(r.converged).sum())
            log(f"(c) eps={eps:g} restart: {conv[eps]}/{self.B_flag} converged, "
                f"max iterations {int(self.np.asarray(r.iterations).max())}, "
                f"max residual {float(self.np.asarray(r.residual).max()):.3e}")
        assert conv[2e-5] == self.B_flag, conv

    def phase_d(self):
        from tpu_gpad import problems
        from tpu_gpad.closed_loop import Controller
        from tpu_gpad.solver import SolverConfig, solve

        np = self.np
        prob = problems.battery(n_cells=3, horizon=10)
        # restart: 100 iterations reach the fixed point from either start,
        # so warm and cold moves must agree
        ctrl = Controller(prob, config=SolverConfig(iterations=100, restart=True))
        x = np.asarray(problems.battery_default_x0(3, seed=2), np.float32)
        A, Bm = np.asarray(prob.A), np.asarray(prob.B)
        worst = 0.0
        for _ in range(20):
            u = ctrl.step(x)
            cold = np.asarray(solve(ctrl.data, self.jax.numpy.asarray(x),
                                    config=ctrl.config).u[0])
            worst = max(worst, float(np.abs(u - cold).max()))
            x = (A @ x + Bm @ u).astype(np.float32)
        log(f"(d) Controller (100 restart iterations), 20 warm-started "
            f"samples: max |u_warm - u_cold| {worst:.3e} (limit 1e-4)")
        assert np.isfinite(x).all() and worst <= 1e-4, worst

    def phase_e(self):
        import tpu_gpad
        from tpu_gpad import problems
        from tpu_gpad.solver import SolverConfig, solve_batch
        from tpu_gpad.stagewise import auto_solver, build_stagewise, solve_stagewise

        np, jax = self.np, self.jax
        n, N, B = self.sw
        solve_fn, data, kind = auto_solver(problems.battery(n, N), iterations=100,
                                           batch_hint=B)
        X = self.batch(n, B) * 0.5
        ce = SolverConfig(mode="eps", eps_g=1e-3, eps_V=1e-3, iterations=1000,
                          restart=True)
        t0 = time.perf_counter()
        r = jax.jit(lambda X: solve_fn(X, config=ce))(X)
        u, resid = np.asarray(r.u), np.asarray(r.residual)
        log(f"(e) battery n{n} N{N} B{B} via auto_solver: kind={kind}, "
            f"{int(np.asarray(r.converged).sum())}/{B} converged at eps 1e-3, "
            f"max residual {resid.max():.3e}, {time.perf_counter() - t0:.1f} s "
            "incl. compile")
        assert kind == "stagewise", kind
        assert np.isfinite(u).all() and resid.max() <= 1e-3, resid.max()
        prob = problems.battery(8, 60)
        cfg = SolverConfig(iterations=300, restart=True)
        X8 = self.batch(8, 16, seed=1) * 0.5
        r_s = jax.jit(lambda X: solve_stagewise(
            build_stagewise(prob, iterations=300), X, config=cfg))(X8)
        r_c = solve_batch(tpu_gpad.dualize(tpu_gpad.condense(prob), iterations=300,
                                           paired="auto"), X8, config=cfg)
        d = float(np.abs(np.asarray(r_s.u) - np.asarray(r_c.u)).max())
        log(f"(e) stage-wise vs condensed at battery n8 N60 (300 restart "
            f"iterations, B=16): max |du| {d:.3e} (limit 1e-4)")
        assert d <= 1e-4, d

    def phase_f(self):
        from tpu_gpad.solver import SolverConfig, core, kernels

        jax, np = self.jax, self.np
        qp, data, X = self.head
        cfg = SolverConfig(iterations=100)
        ok, why = kernels.admits(data, cfg)
        assert ok, why
        solve = lambda lp: jax.jit(lambda X: core._solve_fixed_dual(
            data, *core.affine_params(data, X), cfg, None, lp).u)
        fk, fx = solve(kernels.dual_loop), solve(core._dual_loop)
        uk, ux = np.asarray(fk(X)), np.asarray(fx(X))
        diff = float(np.abs(uk - ux).max())
        err = self.oracle_err(qp, X, uk, 100, 64)
        tk, tx = median_ms(lambda: fk(X)), median_ms(lambda: fx(X))
        log(f"(f) fused dual kernel (Pallas/Triton) at B={self.B_head}, 100 "
            f"iterations, fp32 highest: {tk:.3f} ms vs XLA dual loop "
            f"{tx:.3f} ms per batch; |u_kernel - u_xla| {diff:.3e}, "
            f"u* err vs oracle (64) {err:.3e} (limit 1e-4)")
        assert diff <= 1e-4 and err <= 1e-4, (diff, err)

    def phase_g(self):
        import pytest

        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "--rootdir", REPO,
                          os.path.join(REPO, "tests", "test_dual_kernel.py")])
        log(f"(g) card-only tests (pytest -m gpu): exit code {int(rc)}")
        assert int(rc) == 0, rc

    def multi_gpu(self):
        import tpu_gpad
        from tpu_gpad import problems
        from tpu_gpad.parallel import make_mesh, shard_batch, solve_batch_sharded
        from tpu_gpad.solver import SolverConfig, solve_batch
        from tpu_gpad.solver.core import resolve_engine

        jax, np = self.jax, self.np
        n_dev = len(jax.devices())
        assert n_dev >= 4, f"--multi-gpu needs 4 devices, JAX found {n_dev}"
        qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=10))
        data = tpu_gpad.dualize(qp, iterations=100, paired="auto")
        X = self.batch(3, self.B_head)
        cfg = SolverConfig(iterations=100)
        ref = np.asarray(solve_batch(data, X, config=cfg).u)
        for n_data, n_model in ((4, 1), (2, 2)):
            mesh = make_mesh(n_data=n_data, n_model=n_model,
                             devices=jax.devices()[:4])
            model_axis = "model" if n_model > 1 else None
            run = lambda: solve_batch_sharded(
                data, shard_batch(mesh, X), cfg, mesh=mesh,
                model_axis=model_axis).u
            u = np.asarray(run())
            d = float(np.abs(u - ref).max())
            err = self.oracle_err(qp, X, u, 100, 64)
            engine = resolve_engine(data, SolverConfig(iterations=100,
                                                       model_axis=model_axis))
            log(f"--multi-gpu mesh ({n_data}x{n_model}) B={self.B_head}, "
                f"engine={engine}: "
                f"max |u - u_single| {d:.3e}, u* err vs oracle (64) "
                f"{err:.3e} (limits 1e-4), {median_ms(run, 10):.3f} ms per batch")
            assert d <= 1e-4 and err <= 1e-4, (d, err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the 4-GPU sharded phase")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path.insert(0, REPO)
    import jax

    from tpu_gpad.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    log(f"(a) device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    smoke = Smoke()
    phases = ([smoke.multi_gpu] if args.multi_gpu else
              [smoke.phase_b, smoke.phase_c, smoke.phase_d, smoke.phase_e,
               smoke.phase_f, smoke.phase_g])
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"    [{phase.__name__}: {time.perf_counter() - t0:.1f} s]")
    log(card_line())  # "name, power limit" exactly as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

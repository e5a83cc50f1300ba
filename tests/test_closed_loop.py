"""Closed-loop simulator tests (gpad.m:79-114 behavior)."""

import numpy as np

import tpu_gpad

from tpu_gpad import problems
from tpu_gpad.closed_loop import simulate, plot_closed_loop
from tpu_gpad.solver import SolverConfig


def test_battery_balances_soc():
    """The controller's job: drive all cells to equal SoC while conserving
    total charge (sum(u) = 0 per stage, gpad.m:44)."""
    prob = problems.battery(n_cells=5, horizon=8)
    x0 = problems.battery_default_x0(5)
    # cell capacity limits |dSoC| to ~7.5e-4 per sample at the 0.3 A current
    # cap, so full balancing needs a few hundred samples (reference runs 1000)
    res = simulate(prob, x0, n_steps=400, config=SolverConfig(iterations=80))
    X = np.asarray(res.X[:, 0, :])
    U = np.asarray(res.U[:, 0, :])
    spread0 = X[0].max() - X[0].min()
    spreadT = X[-1].max() - X[-1].min()
    assert spreadT < 0.25 * spread0, (spread0, spreadT)
    # charge conservation: the coupling constraint holds at every sample
    assert np.abs(U.sum(axis=1)).max() < 5e-3
    # input box respected (small dual-infeasibility slack at 80 iterations)
    assert np.abs(U).max() <= 0.3 + 1e-3


def test_total_charge_invariant():
    prob = problems.battery(n_cells=5, horizon=8)
    x0 = problems.battery_default_x0(5)
    res = simulate(prob, x0, n_steps=60, config=SolverConfig(iterations=80))
    X = np.asarray(res.X[:, 0, :])
    # A = I and sum(u)=0 with equal capacities => total SoC is conserved
    np.testing.assert_allclose(X.sum(axis=1), X[0].sum(), atol=2e-3)


def test_batched_closed_loop_matches_single():
    prob = problems.battery(n_cells=3, horizon=6)
    rng = np.random.default_rng(4)
    X0 = rng.uniform(-0.3, 0.3, size=(4, 3)).astype(np.float32)
    rb = simulate(prob, X0, n_steps=20, config=SolverConfig(iterations=60))
    r1 = simulate(prob, X0[1], n_steps=20, config=SolverConfig(iterations=60))
    np.testing.assert_allclose(
        np.asarray(rb.X[:, 1, :]), np.asarray(r1.X[:, 0, :]),
        atol=1e-5,
    )


def test_closed_loop_pallas_engine(interpret_kernel):
    prob = problems.battery(n_cells=3, horizon=6)
    x0 = problems.battery_default_x0(3, seed=2)
    r_x = simulate(prob, x0, n_steps=10, config=SolverConfig(iterations=50, engine="xla"))
    r_p = simulate(prob, x0, n_steps=10, config=SolverConfig(iterations=50, engine="pallas"))
    np.testing.assert_allclose(np.asarray(r_p.X), np.asarray(r_x.X), atol=1e-4)


def test_plot_smoke(tmp_path):
    prob = problems.battery(n_cells=3, horizon=6)
    res = simulate(prob, problems.battery_default_x0(3), n_steps=5,
                   config=SolverConfig(iterations=30))
    out = tmp_path / "traj.png"
    fig = plot_closed_loop(res, path=str(out))
    if fig is not None:
        assert out.exists()


def test_warm_start_improves_accuracy():
    """With the same small iteration budget, warm-started closed loop tracks
    the converged trajectory much better than cold starts. Uses the n=10
    reference initial SoCs (gpad.m:9) whose +-0.45 cells keep state
    constraints active (nontrivial duals)."""
    prob = problems.battery(n_cells=10, horizon=8)
    x0 = problems.battery_default_x0(10)
    ref = simulate(prob, x0, n_steps=40, config=SolverConfig(iterations=1500))
    cold = simulate(prob, x0, n_steps=40, config=SolverConfig(iterations=15))
    warm = simulate(prob, x0, n_steps=40, config=SolverConfig(iterations=15),
                    warm_start=True)
    # sample 0 is identical by construction (no history yet); compare after
    # the warm start has history to exploit
    err_cold = np.abs(np.asarray(cold.U[5:]) - np.asarray(ref.U[5:])).max()
    err_warm = np.abs(np.asarray(warm.U[5:]) - np.asarray(ref.U[5:])).max()
    assert err_warm < 0.5 * err_cold, (err_cold, err_warm)


def test_warm_start_solve_api():
    """Warm-starting from a good dual gets closer to the exact optimum in 50
    iterations than 200 cold iterations did."""
    import tpu_gpad
    from tpu_gpad.solver import solve_batch
    from tpu_gpad.solver.qp import solve_condensed_qp

    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=6))
    data = tpu_gpad.dualize(qp, iterations=200, paired=True)
    x0 = np.asarray(problems.battery_default_x0(3, seed=1), dtype=np.float32)[None]
    exact = solve_condensed_qp(qp, x0[0]).z[: qp.n_u]
    r1 = solve_batch(data, x0, config=SolverConfig(iterations=200))
    r2 = solve_batch(data, x0, config=SolverConfig(iterations=50), y0=r1.y)
    e1 = np.abs(np.asarray(r1.u[0]) - exact).max()
    e2 = np.abs(np.asarray(r2.u[0]) - exact).max()
    assert e2 <= e1 * 1.05, (e1, e2)


def test_closed_loop_pallas_engine_with_warm_start(interpret_kernel):
    """The fused dual kernel drives the closed loop (incl. y0 warm starts)."""
    problem = problems.battery(n_cells=3, horizon=4)
    x0 = np.asarray(problems.battery_default_x0(3, seed=2), dtype=np.float32)
    from tpu_gpad.closed_loop import simulate

    r_xla = simulate(problem, x0, n_steps=15, iterations=40,
                     config=SolverConfig(iterations=40, engine="xla"),
                     warm_start=True)
    r_pl = simulate(problem, x0, n_steps=15, iterations=40,
                    config=SolverConfig(iterations=40, engine="pallas"),
                    warm_start=True)
    np.testing.assert_allclose(
        np.asarray(r_pl.U), np.asarray(r_xla.U), atol=5e-5)


def test_closed_loop_restart_plus_warm_start_is_most_accurate():
    """restart + warm start at a small budget tracks the exact-QP loop."""
    from tpu_gpad.closed_loop import simulate
    from tpu_gpad.solver.qp import solve_condensed_qp

    problem = problems.battery(n_cells=3, horizon=4)
    x0 = np.asarray(problems.battery_default_x0(3, seed=0), dtype=np.float32)
    res = simulate(problem, x0, n_steps=10, iterations=30,
                   config=SolverConfig(iterations=30, restart=True),
                   warm_start=True)
    # exact closed loop for comparison
    qp = tpu_gpad.condense(problem)
    x = x0.astype(np.float64)
    for t in range(10):
        u = solve_condensed_qp(qp, x).z[: qp.n_u]
        err = np.abs(np.asarray(res.U[t, 0]) - u).max()
        assert err < 2e-4, (t, err)
        x = problem.A @ x + problem.B @ u


def test_controller_api_tracks_exact_loop():
    """Controller.step matches the exact-QP controller and beats cold runs."""
    from tpu_gpad.closed_loop import Controller
    from tpu_gpad.solver.qp import solve_condensed_qp

    problem = problems.battery(n_cells=3, horizon=4)
    qp = tpu_gpad.condense(problem)
    ctrl = Controller(problem, iterations=30,
                      config=SolverConfig(iterations=30, restart=True))
    x = np.asarray(problems.battery_default_x0(3, seed=3), dtype=np.float64)
    for t in range(8):
        u = ctrl.step(x.astype(np.float32))
        assert u.shape == (3,)
        exact = solve_condensed_qp(qp, x).z[: qp.n_u]
        assert np.abs(u - exact).max() < 2e-4, (t, np.abs(u - exact).max())
        x = problem.A @ x + problem.B @ u.astype(np.float64)
    # reset drops warm start without breaking subsequent solves
    ctrl.reset()
    u2 = ctrl.step(x.astype(np.float32))
    assert np.all(np.isfinite(u2))


def test_controller_batched_plants():
    from tpu_gpad.closed_loop import Controller

    problem = problems.battery(n_cells=3, horizon=4)
    ctrl = Controller(problem, iterations=40)
    X = np.random.default_rng(0).uniform(-0.3, 0.3, (5, 3)).astype(np.float32)
    U = ctrl.step(X)
    assert U.shape == (5, 3)
    # batch-size change mid-stream silently drops the warm start
    u1 = ctrl.step(X[0])
    np.testing.assert_allclose(u1, U[0], atol=1e-4)


def test_controller_with_polish_is_exact():
    from tpu_gpad.closed_loop import Controller
    from tpu_gpad.solver.qp import solve_condensed_qp

    problem = problems.battery(n_cells=3, horizon=4)
    ctrl = Controller(problem, iterations=60, polish=True,
                      config=SolverConfig(iterations=60, restart=True))
    x = np.asarray(problems.battery_default_x0(3, seed=5), dtype=np.float64)
    for _ in range(5):
        u = ctrl.step(x.astype(np.float32))
        exact = solve_condensed_qp(ctrl.qp, x).z[: ctrl.qp.n_u]
        assert np.abs(u - exact).max() < 1e-6
        x = problem.A @ x + problem.B @ u.astype(np.float64)


def test_controller_soft_state_survives_out_of_box():
    from tpu_gpad.closed_loop import Controller

    problem = problems.battery(n_cells=3, horizon=4)
    ctrl = Controller(problem, iterations=80, soft_state=1e3,
                      config=SolverConfig(iterations=80, restart=True))
    u = ctrl.step(np.asarray([0.7, -0.6, 0.1], dtype=np.float32))
    assert np.all(np.isfinite(u))


def test_controller_shape_stability_and_conflicts():
    from tpu_gpad.closed_loop import Controller

    problem = problems.battery(n_cells=3, horizon=4)
    ctrl = Controller(problem, iterations=30)
    # a (1, n_x) batch stays a batch; a (n_x,) state stays a vector
    assert ctrl.step(np.zeros((1, 3), dtype=np.float32)).shape == (1, 3)
    assert ctrl.step(np.zeros(3, dtype=np.float32)).shape == (3,)
    # prebuilt data + soft_state is contradictory and must be rejected
    import pytest as _pytest

    data = tpu_gpad.dualize(tpu_gpad.condense(problem), iterations=30)
    with _pytest.raises(ValueError, match="soften"):
        Controller(problem, data=data, soft_state=1e3)

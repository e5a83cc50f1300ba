"""Multi-scenario (robust) MPC: tpu_gpad.robust.

The combined QP must be a plain strictly-convex CondensedQP that every
engine solves unchanged; the shared first move must be optimal for the
weighted multi-model objective (checked against the exact active-set QP)
and feasible for every scenario."""

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.robust import scenario_plan, scenario_problem_variants, scenario_qp
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.qp import solve_qp_exact


def _scenario_problems(S=3, horizon=6, seed=0):
    """Battery plant with S perturbed input matrices (capacity spread)."""
    nominal = problems.battery(n_cells=3, horizon=horizon)
    rng = np.random.default_rng(seed)
    B_list = [
        nominal.B * (1.0 + 0.3 * rng.uniform(-1, 1, size=(1, nominal.n_u)))
        for _ in range(S)
    ]
    return scenario_problem_variants(nominal, B_list=B_list)


def test_identical_scenarios_match_nominal():
    """S copies of the same plant == the nominal single-model solve (u0)."""
    nominal = problems.battery(n_cells=3, horizon=6)
    qp_nom = tpu_gpad.condense(nominal)
    qp_rob = scenario_qp([qp_nom, qp_nom, qp_nom])
    x0 = np.array([0.2, -0.1, 0.05], dtype=np.float64)
    ref = solve_qp_exact(
        qp_nom.H, qp_nom.F.T @ x0 + qp_nom.g, qp_nom.G,
        qp_nom.b0 + qp_nom.E @ x0,
    )
    rob = solve_qp_exact(
        qp_rob.H, qp_rob.F.T @ x0 + qp_rob.g, qp_rob.G,
        qp_rob.b0 + qp_rob.E @ x0,
    )
    np.testing.assert_allclose(
        rob.z[: nominal.n_u], ref.z[: nominal.n_u], atol=1e-8
    )


def test_gpad_matches_exact_qp():
    """GPAD (restart, eps) on the stacked QP hits the exact optimum."""
    qps = [tpu_gpad.condense(p) for p in _scenario_problems()]
    qp_rob = scenario_qp(qps)
    data = tpu_gpad.dualize(qp_rob, iterations=3000, paired="auto")
    x0 = np.array([0.25, -0.15, 0.1], dtype=np.float32)
    res = tpu_gpad.solve_to_accuracy(data, x0, tol=1e-7, max_iterations=3000)
    assert np.asarray(res.converged).all()
    exact = solve_qp_exact(
        qp_rob.H, qp_rob.F.T @ x0.astype(np.float64) + qp_rob.g,
        qp_rob.G, qp_rob.b0 + qp_rob.E @ x0.astype(np.float64),
    )
    np.testing.assert_allclose(
        np.asarray(res.u[0]), exact.z[: qp_rob.n_u], atol=1e-4
    )


def test_dedupe_removes_shared_box_rows():
    qps = [tpu_gpad.condense(p) for p in _scenario_problems(S=3)]
    fat = scenario_qp(qps, dedupe=False)
    slim = scenario_qp(qps, dedupe=True)
    assert slim.m < fat.m
    # same optimizer either way
    x0 = np.array([0.1, 0.0, -0.2], dtype=np.float64)
    za = solve_qp_exact(fat.H, fat.F.T @ x0 + fat.g, fat.G,
                        fat.b0 + fat.E @ x0).z
    zb = solve_qp_exact(slim.H, slim.F.T @ x0 + slim.g, slim.G,
                        slim.b0 + slim.E @ x0).z
    np.testing.assert_allclose(za, zb, atol=1e-8)


def test_first_move_feasible_for_every_scenario():
    """The shared u0 respects the input box and each scenario's state box
    one step ahead (the constraints the stacked QP actually imposes)."""
    probs = _scenario_problems(S=4, horizon=5, seed=3)
    qps = [tpu_gpad.condense(p) for p in probs]
    qp_rob = scenario_qp(qps)
    data = tpu_gpad.dualize(qp_rob, iterations=2000, paired="auto")
    x0 = np.array([0.45, -0.3, 0.2], dtype=np.float32)
    res = tpu_gpad.solve_to_accuracy(data, x0, tol=1e-6, max_iterations=2000)
    u0 = np.asarray(res.u[0], dtype=np.float64)
    p0 = probs[0]
    assert (u0 >= p0.u_min - 1e-5).all() and (u0 <= p0.u_max + 1e-5).all()
    for p in probs:
        x1 = p.A @ x0.astype(np.float64) + p.B @ u0
        assert (x1 >= p.x_min - 1e-4).all() and (x1 <= p.x_max + 1e-4).all()


def test_scenario_plan_extraction():
    probs = _scenario_problems(S=2, horizon=4)
    qps = [tpu_gpad.condense(p) for p in probs]
    qp_rob = scenario_qp(qps)
    n_u, N, S = probs[0].n_u, probs[0].horizon, 2
    data = tpu_gpad.dualize(qp_rob, iterations=500, paired="auto")
    x0 = np.array([0.2, -0.1, 0.0], dtype=np.float32)
    res = tpu_gpad.solve(data, x0, config=SolverConfig(iterations=500))
    plans = [
        scenario_plan(np.asarray(res.z[0]), s, n_u, N, S) for s in range(S)
    ]
    for pl in plans:
        assert pl.shape == (N, n_u)
    # shared first move, scenario-specific tails
    np.testing.assert_array_equal(plans[0][0], plans[1][0])
    assert not np.allclose(plans[0][1:], plans[1][1:])


def test_batch_and_engines(interpret_kernel):
    """The stacked QP runs through the batched fused-kernel path."""
    qps = [tpu_gpad.condense(p) for p in _scenario_problems(S=2)]
    qp_rob = scenario_qp(qps)
    data = tpu_gpad.dualize(qp_rob, iterations=200, paired="auto")
    rng = np.random.default_rng(1)
    X0 = rng.uniform(-0.3, 0.3, size=(16, qp_rob.n_x)).astype(np.float32)
    r_xla = solve_batch(data, X0, config=SolverConfig(iterations=200, engine="xla"))
    r_pl = solve_batch(data, X0, config=SolverConfig(iterations=200, engine="pallas"))
    np.testing.assert_allclose(
        np.asarray(r_pl.u), np.asarray(r_xla.u), atol=5e-5
    )


def test_weights_shift_the_compromise():
    """Weighting one scenario heavily pulls u0 toward its solo optimum."""
    probs = _scenario_problems(S=2, horizon=5, seed=9)
    qps = [tpu_gpad.condense(p) for p in probs]
    # small state: u0 stays interior, so the compromise is visible (a
    # saturated u0 is identical across weightings)
    x0 = np.array([0.02, -0.015, 0.01], dtype=np.float64)

    def u0_of(qp_):
        sol = solve_qp_exact(
            qp_.H, qp_.F.T @ x0 + qp_.g, qp_.G, qp_.b0 + qp_.E @ x0
        )
        return sol.z[: qp_.n_u]

    solo0 = u0_of(qps[0])
    heavy0 = u0_of(scenario_qp(qps, weights=[0.999, 0.001]))
    even = u0_of(scenario_qp(qps))
    assert np.linalg.norm(heavy0 - solo0) < np.linalg.norm(even - solo0)


def test_composes_with_tracking():
    """Scenario stacking works on tracking QPs (parameter p = [x0; r])."""
    nominal = problems.double_integrator(horizon=6)
    variants = scenario_problem_variants(
        nominal, B_list=[nominal.B * s for s in (0.7, 1.3)]
    )
    qp_rob = scenario_qp([tpu_gpad.condense(p, tracking=True) for p in variants])
    assert qp_rob.n_x == 4  # [x0; x_ref]
    data = tpu_gpad.dualize(qp_rob, iterations=2000, paired="auto")
    # small setpoint keeps u0 interior (a saturated u0 sits on a degenerate
    # direction where the fp32 fixed point is ~1e-3 off, docs/DESIGN.md §7)
    p = np.array([0.0, 0.0, 0.4, 0.0], dtype=np.float32)
    res = tpu_gpad.solve_to_accuracy(data, p, tol=1e-7, max_iterations=2000)
    exact = solve_qp_exact(
        qp_rob.H, qp_rob.F.T @ p.astype(np.float64) + qp_rob.g,
        qp_rob.G, qp_rob.b0 + qp_rob.E @ p.astype(np.float64),
    )
    np.testing.assert_allclose(
        np.asarray(res.u[0]), exact.z[: qp_rob.n_u], atol=1e-4
    )


def test_controller_from_qp_serves_scenario_stack():
    """Controller.from_qp: warm-started closed-loop serving of the robust
    QP, matching the direct solve_batch answer at every sample."""
    probs = _scenario_problems(S=2, horizon=5, seed=11)
    qps = [tpu_gpad.condense(p) for p in probs]
    qp_rob = scenario_qp(qps)
    cfg = SolverConfig(iterations=300)
    ctrl = tpu_gpad.Controller.from_qp(qp_rob, config=cfg)
    data = ctrl.data
    x = np.array([0.3, -0.2, 0.1], dtype=np.float64)
    y_prev = None
    for t in range(4):
        u = ctrl.step(x.astype(np.float32))
        ref = solve_batch(
            data, np.asarray([x], dtype=np.float32), config=cfg, y0=y_prev
        )
        y_prev = ref.y
        np.testing.assert_array_equal(u, np.asarray(ref.u[0], np.float32))
        x = probs[0].A @ x + probs[0].B @ u.astype(np.float64)
    assert ctrl.last_result is not None


def test_controller_from_qp_tracking_and_polish():
    nominal = problems.double_integrator(horizon=6)
    variants = scenario_problem_variants(
        nominal, B_list=[nominal.B * s for s in (0.8, 1.2)]
    )
    qp_rob = scenario_qp([tpu_gpad.condense(p, tracking=True) for p in variants])
    ctrl = tpu_gpad.Controller.from_qp(
        qp_rob, config=SolverConfig(iterations=400, restart=True, form="dual"),
        tracking=True, polish=True,
    )
    u = ctrl.step(np.zeros(2, np.float32), x_ref=np.array([0.4, 0.0], np.float32))
    p = np.array([0.0, 0.0, 0.4, 0.0], dtype=np.float64)
    exact = solve_qp_exact(
        qp_rob.H, qp_rob.F.T @ p + qp_rob.g, qp_rob.G, qp_rob.b0 + qp_rob.E @ p
    )
    np.testing.assert_allclose(u, exact.z[: qp_rob.n_u], atol=1e-6)
    with pytest.raises(ValueError, match="need `problem`"):
        tpu_gpad.Controller.from_qp(qp_rob, tracking="preview")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scenario_qp_random_problems_match_exact(seed):
    """Property fuzz: random stable plants, random B perturbations — the
    GPAD solve of the stack hits the exact active-set optimum."""
    nominal = problems.random_lti(n_x=3, n_u=2, horizon=5, seed=seed)
    rng = np.random.default_rng(100 + seed)
    variants = scenario_problem_variants(
        nominal,
        B_list=[nominal.B * (1 + 0.25 * rng.uniform(-1, 1)) for _ in range(3)],
    )
    qp_rob = scenario_qp([tpu_gpad.condense(p) for p in variants],
                         weights=rng.uniform(0.5, 2.0, 3))
    data = tpu_gpad.dualize(qp_rob, iterations=3000, paired="auto")
    x0 = rng.uniform(-0.2, 0.2, size=3).astype(np.float32)
    res = tpu_gpad.solve_to_accuracy(data, x0, tol=1e-7, max_iterations=3000)
    assert np.asarray(res.converged).all()
    exact = solve_qp_exact(
        qp_rob.H, qp_rob.F.T @ x0.astype(np.float64) + qp_rob.g,
        qp_rob.G, qp_rob.b0 + qp_rob.E @ x0.astype(np.float64),
    )
    pol = tpu_gpad.polish(qp_rob, x0.astype(np.float64), np.asarray(res.z[0]))
    np.testing.assert_allclose(pol.z, exact.z, atol=1e-8)


def test_certified_bounds_on_scenario_stack():
    """The Algorithm-2 iteration certificates work on robust stacks too."""
    from tpu_gpad.bounds import certify

    nominal = problems.double_integrator(horizon=4)
    variants = scenario_problem_variants(
        nominal, B_list=[nominal.B * s for s in (0.8, 1.2)]
    )
    qp_rob = scenario_qp([tpu_gpad.condense(p) for p in variants])
    n, dn, L = certify(
        qp_rob, np.full(2, -1.0), np.full(2, 1.0), eps_g=1e-3, eps_V=1e-3
    )
    assert n > 0 and np.isfinite(dn.delta) and L > 0


def test_validation_errors():
    qps = [tpu_gpad.condense(p) for p in _scenario_problems(S=2)]
    with pytest.raises(ValueError, match="share"):
        scenario_qp([qps[0], tpu_gpad.condense(problems.battery(3, horizon=4))])
    with pytest.raises(ValueError, match="weights"):
        scenario_qp(qps, weights=[1.0, -1.0])
    with pytest.raises(ValueError, match="n_shared"):
        scenario_qp(qps, n_shared=0)
    with pytest.raises(ValueError, match="at least one"):
        scenario_qp([])


def test_scenario_stagewise_matches_condensed():
    """The stage-wise scenario stack (block plant + stage-0 coupling
    rows) reproduces the condensed scenario_qp's shared move and
    per-scenario tails — robust MPC past the condensation wall
    (VERDICT r04 weak-item 2 tail)."""
    import jax.numpy as jnp

    from tpu_gpad.robust import (
        scenario_stagewise_plans,
        scenario_stagewise_problem,
        scenario_stagewise_x0,
    )
    from tpu_gpad.stagewise import build_stagewise, solve_stagewise

    probs = _scenario_problems(S=3, horizon=6)
    S, n_u, N = 3, probs[0].n_u, probs[0].horizon
    x0 = np.array([0.25, -0.12, 0.06], dtype=np.float64)

    # condensed oracle (exact QP of the selector-form stack)
    qps = [tpu_gpad.condense(p) for p in probs]
    qp_rob = scenario_qp(qps)
    exact = solve_qp_exact(
        qp_rob.H, qp_rob.F.T @ x0 + qp_rob.g, qp_rob.G,
        qp_rob.b0 + qp_rob.E @ x0,
    )
    assert exact.status == "optimal"
    u_shared = exact.z[:n_u]

    # stage-wise stack: converged eps solve
    swp = scenario_stagewise_problem(probs)
    data = build_stagewise(swp, iterations=3000)
    X = jnp.asarray(
        scenario_stagewise_x0(x0, S)[None].astype(np.float32))
    
    eps = 1e-6  # chip fp32 residual floor (DESIGN 4b)
    res = solve_stagewise(
        data, X, mode="eps", eps_g=eps, eps_V=eps, iterations=3000,
        restart=True)
    assert bool(np.all(np.asarray(res.converged)))
    plans = scenario_stagewise_plans(np.asarray(res.z), S, n_u, N)[0]
    # every scenario applies the same first move (non-anticipativity)
    for s in range(1, S):
        np.testing.assert_allclose(plans[s, 0], plans[0, 0],
                                   atol=5e-5)
    np.testing.assert_allclose(plans[0, 0], u_shared,
                               atol=2e-3)
    # per-scenario tails match the condensed extraction
    for s in range(S):
        tail_c = scenario_plan(exact.z, s, n_u, N, S)
        np.testing.assert_allclose(plans[s], tail_c,
                                   atol=2e-3)


def test_scenario_stagewise_weights_and_validation():
    from tpu_gpad.robust import scenario_stagewise_problem

    probs = _scenario_problems(S=2, horizon=5)
    swp = scenario_stagewise_problem(probs, weights=[0.8, 0.2])
    assert swp.horizon == 5 and swp.n_x == 6 and swp.n_u == 6
    with pytest.raises(ValueError, match="at least two"):
        scenario_stagewise_problem(probs[:1])
    import dataclasses

    bad = dataclasses.replace(
        probs[1], du_min=np.full(3, -0.1), du_max=np.full(3, 0.1))
    with pytest.raises(ValueError, match="rate limits"):
        scenario_stagewise_problem([probs[0], bad])

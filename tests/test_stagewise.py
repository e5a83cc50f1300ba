"""Stage-wise (non-condensed) GPAD: parity with the condensed engines.

The stage-wise solver iterates the SAME dual dynamics as the condensed one
(the dual problem is identical — condensation only changes how the oracle
zhat(w) is computed), so with a shared Lipschitz constant and schedule the
two engines must agree to float32 accumulation noise, not just to
convergence tolerance. Reference anchor: the O(N) non-condensed variant the
paper describes but the reference never builds (nmpc12-gpad.pdf p.3;
SURVEY.md section 5)."""

import numpy as np
import pytest


from tpu_gpad import problems
from tpu_gpad.condense import condense, dualize, lipschitz_constant
from tpu_gpad.solver import solve_batch
from tpu_gpad.solver.qp import solve_condensed_qp
from tpu_gpad.stagewise import build_stagewise, solve_stagewise
from tpu_gpad.types import LinearMPCProblem


def _battery_pair(n=3, N=8, iterations=100):
    prob = problems.battery(n, N)
    qp = condense(prob)
    L = lipschitz_constant(qp)
    return prob, qp, L, build_stagewise(prob, iterations=iterations, L=L)


def test_matches_condensed_engine_iterate_for_iterate():
    prob, qp, L, data_s = _battery_pair()
    data_c = dualize(qp, iterations=100, L=L)
    rng = np.random.default_rng(0)
    X0 = rng.uniform(-0.4, 0.4, size=(16, prob.n_x)).astype(np.float32)
    res_c = solve_batch(data_c, X0)
    res_s = solve_stagewise(data_s, X0)
    np.testing.assert_allclose(res_s.u, res_c.u, atol=2e-6)
    # full input trajectory too, not just the first move
    np.testing.assert_allclose(res_s.z, res_c.z, atol=2e-6)


def test_converges_to_exact_qp():
    prob, qp, L, _ = _battery_pair()
    data_s = build_stagewise(prob, iterations=2000, L=L)
    rng = np.random.default_rng(1)
    X0 = rng.uniform(-0.4, 0.4, size=(4, prob.n_x)).astype(np.float32)
    res = solve_stagewise(data_s, X0)
    for i in range(4):
        sol = solve_condensed_qp(qp, X0[i])
        np.testing.assert_allclose(
            np.asarray(res.u)[i], sol.z[: prob.n_u], atol=5e-5
        )
    assert float(np.max(res.residual)) < 1e-4


def test_auto_lipschitz_is_safe_and_close():
    prob, qp, L_exact, _ = _battery_pair()
    data = build_stagewise(prob, iterations=100)
    L_auto = float(data.L)
    assert L_auto >= L_exact * 0.999  # never an underestimate
    assert L_auto <= L_exact * 1.2  # and not uselessly loose here
    rng = np.random.default_rng(2)
    X0 = rng.uniform(-0.4, 0.4, size=(8, prob.n_x)).astype(np.float32)
    res = solve_stagewise(data, X0)
    for i in range(3):
        sol = solve_condensed_qp(qp, X0[i])
        np.testing.assert_allclose(
            np.asarray(res.u)[i], sol.z[: prob.n_u], atol=2e-3
        )


def test_ltv_dynamics():
    prob = problems.random_ltv(n_x=3, n_u=2, horizon=6, seed=3)
    qp = condense(prob)
    L = lipschitz_constant(qp)
    data_c = dualize(qp, iterations=150, L=L)
    data_s = build_stagewise(prob, iterations=150, L=L)
    rng = np.random.default_rng(4)
    X0 = rng.uniform(-0.5, 0.5, size=(6, prob.n_x)).astype(np.float32)
    res_c = solve_batch(data_c, X0)
    res_s = solve_stagewise(data_s, X0)
    np.testing.assert_allclose(res_s.u, res_c.u, atol=5e-6)


def test_terminal_weight_and_per_stage_bounds():
    base = problems.double_integrator(horizon=10)
    from tpu_gpad.condense import dare_terminal_weight

    N, n = base.horizon, base.n_x
    # tightening per-stage state bounds (tube-MPC style, shape (N, n))
    shrink = np.linspace(1.0, 0.6, N)[:, None]
    import dataclasses

    prob = dataclasses.replace(
        base,
        Q_terminal=dare_terminal_weight(base),
        x_min=shrink * np.asarray(base.x_min)[None, :],
        x_max=shrink * np.asarray(base.x_max)[None, :],
    )
    qp = condense(prob)
    L = lipschitz_constant(qp)
    data_c = dualize(qp, iterations=200, L=L)
    data_s = build_stagewise(prob, iterations=200, L=L)
    rng = np.random.default_rng(5)
    X0 = rng.uniform(-0.5, 0.5, size=(5, n)).astype(np.float32)
    np.testing.assert_allclose(
        solve_stagewise(data_s, X0).u, solve_batch(data_c, X0).u,
        atol=5e-6,
    )


def test_general_polytopes():
    base = problems.battery(3, 6)
    import dataclasses

    prob = dataclasses.replace(
        base,
        H_x=np.array([[1.0, 1.0, 1.0]]),  # total-SoC budget
        h_x=np.array([0.9]),
        H_u=np.array([[1.0, -1.0, 0.0]]),
        h_u=np.array([0.25]),
    )
    qp = condense(prob)
    L = lipschitz_constant(qp)
    data_c = dualize(qp, iterations=150, L=L)
    data_s = build_stagewise(prob, iterations=150, L=L)
    rng = np.random.default_rng(6)
    X0 = rng.uniform(-0.3, 0.3, size=(6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        solve_stagewise(data_s, X0).u, solve_batch(data_c, X0).u,
        atol=5e-6,
    )


def test_input_constraints_only():
    prob = LinearMPCProblem(
        A=np.array([[1.0, 0.1], [0.0, 1.0]]),
        B=np.array([[0.0], [0.1]]),
        Q=np.eye(2),
        R=np.eye(1),
        horizon=8,
        u_min=np.array([-1.0]),
        u_max=np.array([1.0]),
        name="inputs_only",
    )
    qp = condense(prob)
    L = lipschitz_constant(qp)
    data_s = build_stagewise(prob, iterations=300, L=L)
    assert data_s.m_x == 0
    X0 = np.array([[1.5, -0.5], [-2.0, 1.0]], dtype=np.float32)
    res = solve_stagewise(data_s, X0)
    for i in range(2):
        sol = solve_condensed_qp(qp, X0[i])
        np.testing.assert_allclose(
            np.asarray(res.u)[i], sol.z[: prob.n_u], atol=1e-4
        )


def test_warm_start_and_batch_shapes():
    prob, qp, L, data = _battery_pair(iterations=100)
    rng = np.random.default_rng(7)
    X0 = rng.uniform(-0.4, 0.4, size=(2, 3, prob.n_x)).astype(np.float32)
    res = solve_stagewise(data, X0, iterations=60)
    assert res.u.shape == (2, 3, prob.n_u)
    assert res.y.shape == (2, 3, prob.horizon, data.m_x + data.m_u)
    assert int(res.iterations[0, 0]) == 60
    # warm-starting from a genuinely converged dual keeps u* put even on a
    # short budget (Lemma 1 of the paper: the iteration is stationary at y*)
    data_long = build_stagewise(prob, iterations=3000, L=L)
    res_star = solve_stagewise(data_long, X0)
    res2 = solve_stagewise(data, X0, iterations=40, y0=res_star.y)
    np.testing.assert_allclose(res2.u, res_star.u, atol=1e-3)


def test_long_horizon_smoke():
    # a shape whose condensed operands are already ~100x the stage-wise
    # data; checks the O(N) path stays correct far past where the dense
    # fixtures live
    prob = problems.battery(4, 120)
    data = build_stagewise(prob, iterations=600)
    rng = np.random.default_rng(8)
    X0 = rng.uniform(-0.3, 0.3, size=(4, 4)).astype(np.float32)
    res = solve_stagewise(data, X0)
    assert np.isfinite(np.asarray(res.u)).all()
    assert float(np.max(res.residual)) < 2e-3
    # charge conservation (the K_u row) holds on the planned moves
    u_traj = np.asarray(res.z).reshape(4, prob.horizon, prob.n_u)
    assert np.abs(u_traj.sum(axis=-1)).max() < 2e-3


def test_rejects_condensation_only_features():
    import dataclasses

    base = problems.battery(3, 4)
    with pytest.raises(ValueError, match="rate limits"):
        build_stagewise(
            dataclasses.replace(
                base, du_min=np.full(3, -0.1), du_max=np.full(3, 0.1)
            )
        )
    # affine offsets are SUPPORTED since round 4 (successive
    # linearization needs them); parity is covered in
    # test_affine_offsets_match_condensed
    with pytest.raises(ValueError, match="no inequality constraints"):
        build_stagewise(
            LinearMPCProblem(
                A=np.eye(2),
                B=np.eye(2),
                Q=np.eye(2),
                R=np.eye(2),
                horizon=3,
            )
        )
    with pytest.raises(ValueError, match="schedule"):
        solve_stagewise(
            build_stagewise(base, iterations=50),
            np.zeros((1, 3), np.float32),
            iterations=60,
        )


def test_associative_scan_matches_sequential():
    # same math, different association order: the parallel-prefix sweeps
    # must agree with lax.scan to fp32 accumulation noise, incl. N=1 and
    # a non-power-of-two horizon
    for n, N in ((3, 1), (3, 8), (4, 13)):
        prob = problems.battery(n, N)
        data = build_stagewise(prob, iterations=100)
        rng = np.random.default_rng(9)
        X0 = rng.uniform(-0.4, 0.4, size=(8, n)).astype(np.float32)
        res_seq = solve_stagewise(data, X0, scan="sequential")
        res_par = solve_stagewise(data, X0, scan="associative")
        np.testing.assert_allclose(res_par.u, res_seq.u, atol=2e-5)
        np.testing.assert_allclose(res_par.z, res_seq.z, atol=2e-5)
    with pytest.raises(ValueError, match="scan"):
        solve_stagewise(data, X0, scan="blockwise")


def test_certified_L_upper_bounds_spectral():
    """The Gramian fallback bound must dominate the exact spectral L.

    Round-3 advisor finding: the old fallback N(|Gx|_F^2+|Gu|_F^2)/lmin(R)
    ignored the prediction-map gain and UNDERestimated the true L by
    2.3x-300x on integrating/unstable plants — these are exactly those
    cases. An underestimated L makes GPAD diverge silently.
    """
    from tpu_gpad.stagewise import _cert_L_np, _stage_seq

    cases = [
        # (A, B, N): single integrator, double integrator dt=0.5, unstable
        (np.array([[1.0]]), np.array([[1.0]]), 10),
        (np.array([[1.0, 0.5], [0.0, 1.0]]), np.array([[0.125], [0.5]]), 20),
        (np.array([[1.3]]), np.array([[1.0]]), 15),
    ]
    for A, B, N in cases:
        n, p = A.shape[0], B.shape[1]
        prob = LinearMPCProblem(
            A=A,
            B=B,
            Q=np.eye(n),
            R=0.1 * np.eye(p),
            horizon=N,
            x_min=-np.ones(n),
            x_max=np.ones(n),
            u_min=-np.ones(p),
            u_max=np.ones(p),
        )
        L_exact = lipschitz_constant(condense(prob))
        A_seq = _stage_seq(prob.A, N, (n, n), "A")
        B_seq = _stage_seq(prob.B, N, (n, p), "B")
        R_seq = _stage_seq(prob.R, N, (p, p), "R")
        from tpu_gpad.stagewise import _constraint_rows

        Gx, _, Gu, _ = _constraint_rows(prob)
        L_cert = _cert_L_np(A_seq, B_seq, Gx, Gu, R_seq)
        assert L_cert >= L_exact * 0.999, (N, L_cert, L_exact)
        # and the auto path (power iteration usually certifies) is safe too
        data = build_stagewise(prob, iterations=100)
        assert float(data.L) >= L_exact * 0.999


def test_eps_mode_converges_to_exact_qp():
    # VERDICT r03 item 5: Algorithm-1 exit for the stage-wise engine,
    # checked against the exact QP (the reference comments this test out,
    # acceldualgrad.m:66-79)
    prob, qp, L, _ = _battery_pair()
    data = build_stagewise(prob, iterations=3000, L=L)
    rng = np.random.default_rng(3)
    X0 = rng.uniform(-0.4, 0.4, size=(4, prob.n_x)).astype(np.float32)
    res = solve_stagewise(
        data, X0, mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10
    )
    assert bool(np.all(np.asarray(res.converged)))
    its = np.asarray(res.iterations)
    assert its.max() < 3000 and its.min() >= 10
    for i in range(4):
        sol = solve_condensed_qp(qp, X0[i])
        np.testing.assert_allclose(
            np.asarray(res.u)[i], sol.z[: prob.n_u], atol=5e-4
        )


def test_eps_mode_matches_condensed_eps_iterations():
    # same dual dynamics + same exit test => same per-scenario iteration
    # counts as the condensed eps engine (XLA loop), not just same u*
    from tpu_gpad.solver import SolverConfig

    prob, qp, L, _ = _battery_pair()
    data_s = build_stagewise(prob, iterations=2000, L=L)
    data_c = dualize(qp, iterations=2000, L=L)
    rng = np.random.default_rng(4)
    X0 = rng.uniform(-0.4, 0.4, size=(8, prob.n_x)).astype(np.float32)
    kw = dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10)
    res_s = solve_stagewise(data_s, X0, **kw)
    res_c = solve_batch(
        data_c, X0,
        config=SolverConfig(iterations=2000, engine="xla", **kw),
    )
    np.testing.assert_array_equal(
        np.asarray(res_s.iterations), np.asarray(res_c.iterations)
    )
    np.testing.assert_allclose(res_s.u, res_c.u, atol=1e-5)


def test_restart_matches_condensed_restart():
    # the restart algebra mirrors core._restart_update: fixed-iteration
    # solves with restart must agree iterate-for-iterate across engines
    from tpu_gpad.solver import SolverConfig

    prob, qp, L, _ = _battery_pair()
    data_s = build_stagewise(prob, iterations=150, L=L)
    data_c = dualize(qp, iterations=150, L=L)
    rng = np.random.default_rng(5)
    X0 = rng.uniform(-0.4, 0.4, size=(8, prob.n_x)).astype(np.float32)
    res_s = solve_stagewise(data_s, X0, restart=True)
    res_c = solve_batch(
        data_c, X0,
        config=SolverConfig(iterations=150, engine="xla", restart=True),
    )
    np.testing.assert_allclose(res_s.u, res_c.u, atol=5e-5)
    np.testing.assert_allclose(res_s.z, res_c.z, atol=5e-5)


def test_restart_speeds_eps_convergence():
    prob, qp, L, _ = _battery_pair()
    data = build_stagewise(prob, iterations=2000, L=L)
    rng = np.random.default_rng(6)
    X0 = rng.uniform(-0.4, 0.4, size=(6, prob.n_x)).astype(np.float32)
    kw = dict(mode="eps", eps_g=1e-6, eps_V=1e-6, check_every=10)
    plain = solve_stagewise(data, X0, **kw)
    re = solve_stagewise(data, X0, restart=True, **kw)
    assert bool(np.all(np.asarray(re.converged)))
    assert int(np.asarray(re.iterations).max()) <= int(
        np.asarray(plain.iterations).max()
    )


def test_solver_config_passthrough():
    from tpu_gpad.solver import SolverConfig

    prob, qp, L, _ = _battery_pair()
    data = build_stagewise(prob, iterations=500, L=L)
    rng = np.random.default_rng(7)
    X0 = rng.uniform(-0.3, 0.3, size=(3, prob.n_x)).astype(np.float32)
    cfg = SolverConfig(iterations=500, mode="eps", eps_g=1e-4, eps_V=1e-4,
                       restart=True)
    res = solve_stagewise(data, X0, config=cfg)
    assert bool(np.all(np.asarray(res.converged)))


def test_condense_oversized_redirects_to_stagewise(monkeypatch):
    # VERDICT r03 item 5: condensation-infeasible shapes must point the
    # user at the O(N) engine, not die with a bare MemoryError
    monkeypatch.setenv("TPU_GPAD_CONDENSE_LIMIT_GB", "0.001")
    prob = problems.battery(8, 60)
    with pytest.raises(ValueError, match="build_stagewise"):
        condense(prob)
    # incompatible problems say WHY stagewise can't take them either
    import dataclasses

    prob2 = dataclasses.replace(
        prob, du_min=np.full(prob.n_u, -0.1), du_max=np.full(prob.n_u, 0.1)
    )
    with pytest.raises(ValueError, match="rate limits"):
        condense(prob2)


def test_auto_solver_routes_by_operand_size():
    from tpu_gpad.stagewise import auto_solver, condensed_operand_mb

    prob_small = problems.battery(3, 8)
    fn, data, kind = auto_solver(prob_small, iterations=100)
    assert kind == "condensed"
    prob_long = problems.battery(3, 8)
    # force the threshold below this problem's operands
    fn2, data2, kind2 = auto_solver(
        prob_long, iterations=100, threshold_mb=1e-6
    )
    assert kind2 == "stagewise"
    rng = np.random.default_rng(11)
    X0 = rng.uniform(-0.3, 0.3, size=(4, prob_small.n_x)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(fn(X0).u), np.asarray(fn2(X0).u), atol=5e-4
    )
    assert condensed_operand_mb(prob_small) > 0


def test_auto_routing_table_pins_measured_crossover():
    """The routing table of ``stagewise_preferred`` on the ladder rows it
    was tuned on (thresholds queued for re-measurement on the GPU)."""
    from tpu_gpad.stagewise import stagewise_preferred

    # (n_cells, N, batch, expected) for the 9 ladder rows
    table = [
        (8, 10, 1024, False),
        (8, 60, 256, False),
        (8, 120, 256, False),
        (8, 240, 128, True),
        (30, 200, 64, True),    # also past the memory backstop
        (8, 60, 4096, True),    # large-batch branch
        (8, 120, 4096, True),   # large-batch branch
        (8, 240, 4096, True),
        (30, 200, 1024, True),
    ]
    for n, N, B, expect in table:
        prob = problems.battery(n, N)
        got, reason = stagewise_preferred(prob, batch_hint=B)
        assert got == expect, (n, N, B, reason)
    # batch-agnostic calls keep condensed below the any-batch crossover
    assert not stagewise_preferred(problems.battery(8, 120))[0]
    assert stagewise_preferred(problems.battery(8, 240))[0]
    # tiny per-stage state: the throughput branches are OFF — only the
    # memory backstop routes
    got, why = stagewise_preferred(problems.battery(3, 240),
                                   batch_hint=4096)
    assert not got and "per-stage state too small" in why
    assert stagewise_preferred(problems.battery(3, 240),
                               threshold_mb=1e-6)[0]


def test_auto_solver_batch_hint_and_x_ref():
    """batch_hint enables the large-batch branch; x_ref (a stage-wise-only
    build option) forces the stage-wise route instead of a TypeError on
    the condensed branch (r04 advisor finding)."""
    from tpu_gpad.stagewise import auto_solver

    prob = problems.battery(3, 8)
    _, _, kind = auto_solver(prob, iterations=50)
    assert kind == "condensed"
    # x_ref on a condensed-routed problem: feature-routes stage-wise
    fn, data, kind = auto_solver(
        prob, iterations=50, x_ref=np.zeros(prob.n_x)
    )
    assert kind == "stagewise"
    X0 = np.zeros((2, prob.n_x), dtype=np.float32)
    fn(X0)  # solves without error
    # large-batch branch at the measured kernel-win region (n8: the
    # measured family; tiny-state plants stay condensed — see the
    # routing-table test)
    _, _, kind = auto_solver(
        problems.battery(8, 60), iterations=50, batch_hint=4096
    )
    assert kind == "stagewise"
    _, _, kind = auto_solver(
        problems.battery(8, 60), iterations=50, batch_hint=256
    )
    assert kind == "condensed"


def test_stagewise_controller_batch_shape_change_resets_warm_start():
    """A stored (B1, N, m) dual neither crashes nor silently broadcasts
    onto a different batch (r04 advisor finding): the controller drops
    the warm start on a batch-shape change."""
    from tpu_gpad.stagewise import StagewiseController

    ctrl = StagewiseController(problems.battery(3, 6), iterations=40)
    rng = np.random.default_rng(3)
    u1 = ctrl.step(rng.uniform(-0.3, 0.3, size=(4, 3)).astype(np.float32))
    assert u1.shape == (4, 3)
    assert ctrl._y is not None and ctrl._y.shape[0] == 4
    # shrink, grow, and single-state calls all work
    u2 = ctrl.step(rng.uniform(-0.3, 0.3, size=(2, 3)).astype(np.float32))
    assert u2.shape == (2, 3) and ctrl._y.shape[0] == 2
    u3 = ctrl.step(rng.uniform(-0.3, 0.3, size=(8, 3)).astype(np.float32))
    assert u3.shape == (8, 3) and ctrl._y.shape[0] == 8
    u4 = ctrl.step(rng.uniform(-0.3, 0.3, size=3).astype(np.float32))
    assert u4.shape == (3,)


def test_solve_stagewise_jit_matches_unjitted():
    from tpu_gpad.stagewise import solve_stagewise_jit
    from tpu_gpad.solver import SolverConfig

    prob = problems.battery(3, 6)
    data = build_stagewise(prob, iterations=50)
    rng = np.random.default_rng(5)
    X0 = rng.uniform(-0.3, 0.3, size=(4, 3)).astype(np.float32)
    cfg = SolverConfig(iterations=50)
    ref = solve_stagewise(data, X0, config=cfg)
    res = solve_stagewise_jit(data, X0, config=cfg)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(ref.u),
                               atol=1e-6)
    # warm-started entry agrees with the functional path too
    ref_w = solve_stagewise(data, X0, y0=ref.y, config=cfg)
    res_w = solve_stagewise_jit(data, X0, y0=ref.y, config=cfg)
    np.testing.assert_allclose(np.asarray(res_w.u), np.asarray(ref_w.u),
                               atol=1e-6)


def test_runtime_q_lin_matches_baked_x_ref():
    """solve_stagewise(q_lin=-Q r) == build_stagewise(x_ref=r): the
    runtime linear-cost parameter reproduces the build-time baked
    reference exactly (same algebra, device-side)."""
    import jax.numpy as jnp

    prob = problems.battery(3, 7)
    rng = np.random.default_rng(8)
    ref = rng.uniform(-0.2, 0.2, size=(7, 3))
    baked = build_stagewise(prob, iterations=60, x_ref=ref)
    plain = build_stagewise(prob, iterations=60)
    X0 = rng.uniform(-0.3, 0.3, size=(5, 3)).astype(np.float32)
    q_lin = -np.einsum("ij,kj->ki", np.asarray(prob.Q, float), ref)
    res_b = solve_stagewise(baked, X0)
    res_q = solve_stagewise(plain, X0, q_lin=jnp.asarray(q_lin, jnp.float32))
    np.testing.assert_allclose(
        np.asarray(res_q.u), np.asarray(res_b.u),
        atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(res_q.y), np.asarray(res_b.y),
        atol=5e-6)
    # per-example q_lin: scenario 0 tracks ref, scenario 1 tracks zero
    qb = np.stack([q_lin, np.zeros_like(q_lin)]).astype(np.float32)
    res_mix = solve_stagewise(plain, X0[:2], q_lin=jnp.asarray(qb))
    res_z = solve_stagewise(plain, X0[1:2])
    np.testing.assert_allclose(
        np.asarray(res_mix.u[0]), np.asarray(res_b.u[0]),
        atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(res_mix.u[1]), np.asarray(res_z.u[0]),
        atol=2e-6)


def test_runtime_c_matches_baked_affine():
    """solve_stagewise(c=...) == build_stagewise on a problem with the
    same build-time affine offsets, in both fixed and eps modes."""
    import dataclasses as _dc

    import jax.numpy as jnp

    prob = problems.battery(3, 7)
    rng = np.random.default_rng(9)
    cs = rng.uniform(-0.02, 0.02, size=(7, 3))
    prob_c = _dc.replace(prob, c=cs)
    baked = build_stagewise(prob_c, iterations=60)
    plain = build_stagewise(prob, iterations=60)
    X0 = rng.uniform(-0.3, 0.3, size=(4, 3)).astype(np.float32)
    res_b = solve_stagewise(baked, X0)
    res_c = solve_stagewise(plain, X0, c=jnp.asarray(cs, jnp.float32))
    np.testing.assert_allclose(
        np.asarray(res_c.u), np.asarray(res_b.u),
        atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(res_c.z), np.asarray(res_b.z),
        atol=2e-6)
    # eps mode rides the same per-solve constants (incl. _rollout's c)
    res_be = solve_stagewise(baked, X0, mode="eps", eps_g=1e-5,
                             eps_V=1e-5, iterations=60)
    res_ce = solve_stagewise(plain, X0, mode="eps", eps_g=1e-5,
                             eps_V=1e-5, iterations=60,
                             c=jnp.asarray(cs, jnp.float32))
    np.testing.assert_allclose(
        np.asarray(res_ce.u), np.asarray(res_be.u),
        atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(res_ce.iterations), np.asarray(res_be.iterations))
    # associative executor sees the same effective constants
    res_ca = solve_stagewise(plain, X0, scan="associative",
                             c=jnp.asarray(cs, jnp.float32))
    np.testing.assert_allclose(
        np.asarray(res_ca.u), np.asarray(res_b.u),
        atol=5e-6)


def test_multi_plant_stagewise_solve():
    """stack_stagewise + solve_stagewise_multi: P plants with DIFFERENT
    dynamics in one vmapped device call == per-plant solves (the O(N)
    twin of solver.multi.stack_data/solve_multi)."""
    import jax.numpy as jnp

    from tpu_gpad.stagewise import solve_stagewise_multi, stack_stagewise

    datas = [
        build_stagewise(
            problems.random_ltv(n_x=3, n_u=2, horizon=6, seed=s),
            iterations=60,
        )
        for s in range(3)
    ]
    st = stack_stagewise(datas)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(-0.3, 0.3, size=(3, 3)).astype(np.float32))
    res = solve_stagewise_multi(st, X, iterations=60)
    for p in range(3):
        ref = solve_stagewise(datas[p], X[p][None], iterations=60)
        np.testing.assert_allclose(
            np.asarray(res.u[p]), np.asarray(ref.u[0]),
            atol=1e-6)
    # inner per-plant batches + eps mode + warm start
    X2 = jnp.asarray(
        rng.uniform(-0.3, 0.3, size=(3, 4, 3)).astype(np.float32))
    res2 = solve_stagewise_multi(
        st, X2, mode="eps", eps_g=1e-4, eps_V=1e-4, iterations=300,
        restart=True)
    assert bool(np.all(np.asarray(res2.converged)))
    res3 = solve_stagewise_multi(st, X2, iterations=60, y0=res2.y)
    assert res3.u.shape == (3, 4, 2)
    # mismatched shapes refuse loudly
    import pytest as _pytest

    bad = build_stagewise(problems.battery(3, 8), iterations=60)
    with _pytest.raises(ValueError, match="identical shapes"):
        stack_stagewise([datas[0], bad])


def test_cli_stagewise_engine(capsys):
    import json as _json

    from tpu_gpad.cli import main as cli_main

    rc = cli_main([
        "solve", "--problem", "battery", "--cells", "3", "--horizon", "8",
        "--batch", "4", "--engine", "stagewise", "--mode", "eps",
        "--eps-g", "1e-4", "--eps-v", "1e-4", "--iterations", "1500",
        "--restart",
    ])
    assert rc == 0
    out = _json.loads(capsys.readouterr().out)
    assert out["engine"] == "stagewise"
    assert out["converged_all"] is True


def test_residual_clamped_like_condensed_public_results():
    """Public SolveResult.residual is clamped at zero on EVERY engine
    (core.py returns maximum(viol, 0) at all three sites); the stage-wise
    path must match, so cross-engine consumers see one semantics for
    strictly feasible solves."""
    import tpu_gpad
    from tpu_gpad import problems
    from tpu_gpad.solver import SolverConfig, solve_batch
    from tpu_gpad.stagewise import build_stagewise, solve_stagewise
    import jax.numpy as jnp

    prob = problems.battery(n_cells=2, horizon=5)
    x0 = np.full((1, 2), 0.01, dtype=np.float32)  # deep-interior state
    sw = build_stagewise(prob, iterations=300)
    r_sw = solve_stagewise(sw, jnp.asarray(x0))
    data = tpu_gpad.dualize(tpu_gpad.condense(prob), iterations=300)
    r_c = solve_batch(data, jnp.asarray(x0), config=SolverConfig(iterations=300))
    for res in (r_sw, r_c):
        assert float(np.min(np.asarray(res.residual))) >= 0.0
    # eps path too
    cfg = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, iterations=300)
    r_eps = solve_stagewise(sw, jnp.asarray(x0), config=cfg)
    assert float(np.min(np.asarray(r_eps.residual))) >= 0.0


def test_stagewise_controller_closed_loop():
    """StagewiseController serves a closed loop with dual warm starts:
    after the first sample, warm-started steps at a SHORT budget match
    the cold full-budget control within fp32 closed-loop tolerance, and
    the loop balances the battery like the condensed Controller would."""
    import jax.numpy as jnp  # noqa: F401  (jnp used via module import)
    from tpu_gpad.solver import SolverConfig
    from tpu_gpad.stagewise import StagewiseController

    prob = problems.battery(3, 12)
    ctl = StagewiseController(prob, iterations=400)
    cold = StagewiseController(prob, iterations=400, warm_start=False)
    x = np.array([0.3, -0.2, 0.05], dtype=np.float32)
    xc = x.copy()
    A = np.asarray(prob.A, dtype=np.float32)
    B = np.asarray(prob.B, dtype=np.float32)
    for t in range(15):
        u = ctl.step(x)
        u_cold = cold.step(xc)
        if t > 0:
            np.testing.assert_allclose(u, u_cold, atol=5e-4)
        x = A @ x + B @ u
        xc = A @ xc + B @ u_cold
    # balancing direction: cell-SoC spread strictly shrinks (the battery
    # balancing currents are small, so 15 steps only move it a few %)
    assert np.std(x) < np.std([0.3, -0.2, 0.05]) - 1e-3
    # batch step shape contract + reset drops the warm start
    ub = ctl.step(np.stack([x, xc]))
    assert ub.shape == (2, 3)
    ctl.reset()
    assert ctl._y is None


def test_affine_offsets_match_condensed():
    """x+ = Ax + Bu + c: the stage-wise oracle's affine Riccati constants
    (dtl = Ptilde c, folded qoff) reproduce the condensed engine's
    iterates exactly (same dual problem, shared L/schedule)."""
    import dataclasses

    base = problems.battery(3, 7)
    prob = dataclasses.replace(base, c=np.array([0.02, -0.01, 0.015]))
    qp = condense(prob)
    L = lipschitz_constant(qp)
    data_c = dualize(qp, iterations=150, L=L)
    data_s = build_stagewise(prob, iterations=150, L=L)
    rng = np.random.default_rng(11)
    X0 = rng.uniform(-0.3, 0.3, size=(6, 3)).astype(np.float32)
    res_c = solve_batch(data_c, X0)
    res_s = solve_stagewise(data_s, X0, scan="sequential")
    np.testing.assert_allclose(res_s.u, res_c.u, atol=5e-6)
    np.testing.assert_allclose(res_s.z, res_c.z, atol=5e-6)
    # the associative executor agrees too
    res_a = solve_stagewise(data_s, X0, scan="associative")
    np.testing.assert_allclose(res_a.u, res_c.u, atol=5e-6)
    # and per-stage LTV offsets
    prob2 = dataclasses.replace(
        problems.random_ltv(n_x=3, n_u=2, horizon=5, seed=8),
        c=rng.normal(scale=0.02, size=(5, 3)),
    )
    qp2 = condense(prob2)
    L2 = lipschitz_constant(qp2)
    d_c2 = dualize(qp2, iterations=150, L=L2)
    d_s2 = build_stagewise(prob2, iterations=150, L=L2)
    X2 = rng.uniform(-0.4, 0.4, size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        solve_stagewise(d_s2, X2).u, solve_batch(d_c2, X2).u,
        atol=5e-6,
    )


def test_fixed_reference_matches_condensed_tracking():
    """build_stagewise(x_ref=...) bakes a FIXED setpoint into qoff; the
    condensed twin passes the same reference as its runtime tracking
    parameter — iterates must agree."""
    prob = problems.double_integrator(horizon=8)
    ref = np.array([0.25, 0.0])
    qp = condense(prob, tracking=True)
    L = lipschitz_constant(qp)
    data_c = dualize(qp, iterations=200, L=L)
    data_s = build_stagewise(prob, iterations=200, L=L, x_ref=ref)
    rng = np.random.default_rng(12)
    X0 = rng.uniform(-0.4, 0.4, size=(5, 2)).astype(np.float32)
    P = np.concatenate(
        [X0, np.tile(ref[None, :], (5, 1))], axis=1
    ).astype(np.float32)
    res_c = solve_batch(data_c, P)
    res_s = solve_stagewise(data_s, X0)
    np.testing.assert_allclose(res_s.u, res_c.u, atol=5e-6)
    # the tracked closed loop actually goes to the setpoint
    x = np.asarray(X0[0], dtype=np.float32)
    A = np.asarray(prob.A, dtype=np.float32)
    B = np.asarray(prob.B, dtype=np.float32)
    for _ in range(60):
        u = np.asarray(solve_stagewise(data_s, x[None]).u)[0]
        x = A @ x + B @ u
    assert abs(x[0] - ref[0]) < 0.05


def test_multi_plant_stagewise_sharded():
    """solve_stagewise_multi_sharded: P heterogeneous plants sharded
    one-per-device-column over the virtual mesh == the unsharded
    multi-plant solve (the O(N) twin of solve_multi_sharded)."""
    import jax
    import jax.numpy as jnp

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual multi-device mesh")
    from tpu_gpad.parallel import make_mesh, solve_stagewise_multi_sharded
    from tpu_gpad.solver import SolverConfig
    from tpu_gpad.stagewise import solve_stagewise_multi, stack_stagewise

    datas = [
        build_stagewise(
            problems.random_ltv(n_x=3, n_u=2, horizon=6, seed=s),
            iterations=60,
        )
        for s in range(4)
    ]
    st = stack_stagewise(datas)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.uniform(-0.3, 0.3, size=(4, 2, 3)).astype(np.float32))
    mesh = make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    cfg = SolverConfig(iterations=60)
    res_sh = solve_stagewise_multi_sharded(st, X, cfg, mesh=mesh)
    ref = solve_stagewise_multi(st, X, config=cfg)
    np.testing.assert_allclose(
        np.asarray(res_sh.u), np.asarray(ref.u), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(res_sh.y), np.asarray(ref.y), atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        solve_stagewise_multi_sharded(st, X[:3], cfg, mesh=mesh)

"""Per-stage box bounds + tube-MPC constraint tightening (tpu_gpad.robust)."""

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.robust import lqr_gain, tube_tightened_problem
from tpu_gpad.solver import SolverConfig
from tpu_gpad.solver.qp import solve_qp_exact


def test_per_stage_bounds_bind_the_right_stage():
    """A u_max that is tight only at stage 2 must clip exactly u_2."""
    import dataclasses

    base = problems.double_integrator(horizon=5)
    u_max = np.tile(base.u_max, (5, 1))
    u_max[2] = 0.05
    prob = dataclasses.replace(base, u_max=u_max)
    qp = tpu_gpad.condense(prob)
    x0 = np.array([8.0, 0.0])  # wants a hard push toward the origin
    sol = solve_qp_exact(qp.H, qp.F.T @ x0 + qp.g, qp.G, qp.b0 + qp.E @ x0)
    u_plan = sol.z.reshape(5, 1)
    assert u_plan[2, 0] <= 0.05 + 1e-8
    # the constant-bound problem uses full authority at stage 2
    qp0 = tpu_gpad.condense(base)
    sol0 = solve_qp_exact(qp0.H, qp0.F.T @ x0 + qp0.g, qp0.G, qp0.b0 + qp0.E @ x0)
    assert abs(sol0.z.reshape(5, 1)[2, 0]) > 0.05


def test_per_stage_bounds_constant_equivalence():
    """(N, n)-tiled constant bounds == the (n,) constant bounds."""
    import dataclasses

    base = problems.battery(n_cells=3, horizon=6)
    tiled = dataclasses.replace(
        base,
        x_min=np.tile(base.x_min, (6, 1)),
        x_max=np.tile(base.x_max, (6, 1)),
        u_min=np.tile(base.u_min, (6, 1)),
        u_max=np.tile(base.u_max, (6, 1)),
    )
    qa, qb = tpu_gpad.condense(base), tpu_gpad.condense(tiled)
    np.testing.assert_array_equal(qa.G, qb.G)
    np.testing.assert_array_equal(qa.b0, qb.b0)
    np.testing.assert_array_equal(qa.E, qb.E)


def test_per_stage_bounds_validation():
    import dataclasses

    base = problems.double_integrator(horizon=4)
    bad = dataclasses.replace(base, u_max=np.zeros((3, 1)))
    with pytest.raises(ValueError, match="u_max must be"):
        tpu_gpad.condense(bad)


def test_tube_margins_match_hand_computation():
    prob = problems.double_integrator(horizon=3, x_limit=10.0, u_limit=1.0)
    w = np.array([0.1, 0.05])
    tight = tube_tightened_problem(prob, w)  # K = 0: margins sum |A^j| w
    A = prob.A
    m1 = w
    m2 = w + np.abs(A) @ w
    m3 = m2 + np.abs(A @ A) @ w
    np.testing.assert_allclose(tight.x_max[0], prob.x_max - m1)
    np.testing.assert_allclose(tight.x_max[1], prob.x_max - m2)
    np.testing.assert_allclose(tight.x_max[2], prob.x_max - m3)
    # without feedback the input boxes are untouched
    np.testing.assert_allclose(np.tile(prob.u_max, (3, 1)),
                               np.atleast_2d(tight.u_max))


def test_tube_with_lqr_gain_tightens_inputs_and_shrinks_slower():
    prob = problems.double_integrator(horizon=8, x_limit=10.0, u_limit=1.0)
    w = np.array([0.05, 0.05])
    K = lqr_gain(prob)
    assert np.max(np.abs(np.linalg.eigvals(prob.A + prob.B @ K))) < 1.0
    open_loop = tube_tightened_problem(prob, w)
    closed = tube_tightened_problem(prob, w, K=K)
    # the stabilized tube is smaller at the end of the horizon
    assert (closed.x_max[-1] > open_loop.x_max[-1]).all()
    # the ancillary feedback consumes input authority at later stages
    assert (closed.u_max[1:] < prob.u_max).all()
    assert np.allclose(closed.u_max[0], prob.u_max)  # m_0 = 0


def test_tube_outgrowing_box_raises():
    prob = problems.double_integrator(horizon=12, x_limit=1.0, u_limit=1.0)
    with pytest.raises(ValueError, match="outgrows"):
        tube_tightened_problem(prob, np.array([0.5, 0.5]))


def test_tube_feedback_refuses_rate_limited_problems():
    """K e_k perturbs the applied input, which the tightening does not
    propagate into du/K_u rows — raising beats a vacuous guarantee."""
    import dataclasses

    prob = dataclasses.replace(
        problems.double_integrator(horizon=6),
        du_min=np.array([-0.5]), du_max=np.array([0.5]),
    )
    K = lqr_gain(prob)
    with pytest.raises(ValueError, match="du_min/du_max/K_u"):
        tube_tightened_problem(prob, np.array([0.01, 0.01]), K=K)
    # open-loop tube (nominal input applied verbatim) stays allowed
    tight = tube_tightened_problem(prob, np.array([0.01, 0.01]))
    assert tight.du_max is not None


def test_tube_closed_loop_never_violates_original_box():
    """Vertex disturbances in the box: the tube controller keeps the TRUE
    state inside the ORIGINAL constraints at every sample."""
    rng = np.random.default_rng(0)
    prob = problems.double_integrator(horizon=10, x_limit=5.0, u_limit=1.0,
                                      qu_weight=0.05)
    w_max = np.array([0.0, 0.12])  # force disturbance on the velocity
    K = lqr_gain(prob)
    tight = tube_tightened_problem(prob, w_max, K=K)
    data_t = tpu_gpad.dualize(tpu_gpad.condense(tight), iterations=2000,
                              paired="auto")

    def run(data):
        x = np.array([-4.2, 2.0])  # fast approach toward the +5 wall... from below
        worst = -np.inf
        for t in range(30):
            res = tpu_gpad.solve_to_accuracy(
                data, x.astype(np.float32), tol=1e-6, max_iterations=2000
            )
            if not np.asarray(res.converged).all():
                break  # infeasible qp: the controller lost the game
            u = float(np.asarray(res.u[0])[0])
            w = w_max * rng.choice([-1.0, 1.0], size=2)  # vertex disturbance
            x = prob.A @ x + prob.B[:, 0] * u + w
            worst = max(worst, np.abs(x).max())
        return worst

    worst_tube = run(data_t)
    assert worst_tube <= 5.0 + 1e-6


def test_per_stage_bounds_compose_with_soft_state():
    """Per-stage state boxes soften like constant ones (same row counts)."""
    import dataclasses

    base = problems.double_integrator(horizon=4)
    xb = np.tile(base.x_max, (4, 1))
    xb[2] = 0.5
    prob = dataclasses.replace(base, x_max=xb, x_min=-xb)
    qp = tpu_gpad.condense(prob, soft_state=100.0)
    data = tpu_gpad.dualize(qp, iterations=100)
    # infeasible-for-hard-boxes state: the soft problem still solves
    res = tpu_gpad.solve(data, np.array([20.0, 0.0], np.float32))
    assert np.isfinite(np.asarray(res.u)).all()


def test_tube_composes_with_condense_and_engines(interpret_kernel):
    prob = problems.double_integrator(horizon=6)
    tight = tube_tightened_problem(prob, np.array([0.02, 0.02]),
                                   K=lqr_gain(prob))
    data = tpu_gpad.dualize(tpu_gpad.condense(tight), iterations=300,
                            paired="auto")
    X0 = np.random.default_rng(2).uniform(-3, 3, size=(8, 2)).astype(np.float32)
    from tpu_gpad.solver import solve_batch

    r_x = solve_batch(data, X0, config=SolverConfig(iterations=300, engine="xla"))
    r_p = solve_batch(data, X0, config=SolverConfig(iterations=300, engine="pallas"))
    np.testing.assert_allclose(np.asarray(r_p.u), np.asarray(r_x.u), atol=5e-5)

"""Affine-offset condensation + the successive-linearization NMPC layer.

The reference is strictly LTI; these pin the nonlinear extension:
known per-stage offsets c_k folded into the QP constants (b0, g), exact
linearization residuals, and a closed-loop pendulum swing to the upright
(unstable) equilibrium under torque limits.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.condense import condense, prediction_matrices
from tpu_gpad.nonlinear import NMPC, linearize, rk4, rollout, simulate_nonlinear
from tpu_gpad.problems.pendulum import UPRIGHT, pendulum_dynamics
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.qp import solve_condensed_qp


# ---------------------------------------------------------------- offsets


def test_affine_offset_prediction(rng):
    """With c set, the condensed state-box RHS must track the offset
    recurrence off_{k+1} = A off_k + c_k (time-varying offsets)."""
    prob0 = problems.random_lti(n_x=3, n_u=2, horizon=5, seed=4)
    c = rng.normal(size=(5, 3)) * 0.1
    prob = dataclasses.replace(prob0, c=c)
    qp0 = condense(prob0)
    qp = condense(prob)
    assert qp.name.endswith("_aff")
    # offsets by brute force
    off, offs = np.zeros(3), []
    for k in range(5):
        off = prob0.A @ off + c[k]
        offs.append(off.copy())
    offs = np.concatenate(offs)
    # upper state-box rows: b0 shifted by -offs; lower by +offs
    np.testing.assert_allclose(qp.b0[:15], qp0.b0[:15] - offs, atol=1e-10)
    np.testing.assert_allclose(qp.b0[15:30], qp0.b0[15:30] + offs, atol=1e-10)
    # linear cost: g = S' Qbar s_off
    T, S = prediction_matrices(prob0.A, prob0.B, 5)
    Qbar = np.kron(np.eye(5), prob0.Q)
    np.testing.assert_allclose(qp.g, S.T @ Qbar @ offs, atol=1e-10)
    # everything else identical
    np.testing.assert_allclose(qp.H, qp0.H)
    np.testing.assert_allclose(qp.G, qp0.G)
    np.testing.assert_allclose(qp.E, qp0.E)


def test_affine_offset_solve_matches_exact_qp():
    """GPAD on an offset problem agrees with the exact QP (g and b0 both
    carry the offset, so this exercises the whole gP_const/pD_const path)."""
    prob0 = problems.random_lti(n_x=4, n_u=2, horizon=6, seed=9)
    rng = np.random.default_rng(0)
    prob = dataclasses.replace(prob0, c=rng.normal(size=4) * 0.05)
    qp = condense(prob)
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    X0 = rng.uniform(-0.8, 0.8, size=(6, 4)).astype(np.float32)
    res = solve_batch(data, X0, config=SolverConfig(iterations=400, restart=True))
    checked = 0
    for i in range(6):
        sol = solve_condensed_qp(qp, X0[i])
        if sol.status != "optimal":
            continue
        checked += 1
        err = np.abs(np.asarray(res.u[i]) - sol.z[: qp.n_u]).max()
        assert err < 5e-4, (i, err)
    assert checked >= 3


def test_affine_offset_zero_is_identity():
    prob0 = problems.random_lti(n_x=3, n_u=2, horizon=4, seed=2)
    prob = dataclasses.replace(prob0, c=np.zeros(3))
    qp0, qp = condense(prob0), condense(prob)
    np.testing.assert_allclose(qp.b0, qp0.b0)
    np.testing.assert_allclose(qp.g, qp0.g)


def test_affine_offset_guards():
    prob = dataclasses.replace(
        problems.random_lti(horizon=4), c=np.zeros((3, 4))
    )
    with pytest.raises(ValueError, match="c must be"):
        condense(prob)
    with pytest.raises(ValueError, match="time-invariant offset-free"):
        tpu_gpad.simulate(
            dataclasses.replace(problems.random_lti(horizon=4), c=np.zeros(4)),
            np.zeros(4),
            n_steps=2,
        )


# ------------------------------------------------------------ linearization


def test_linearize_exact_on_linear_dynamics(rng):
    """On a linear f the Jacobians are the matrices and c = 0."""
    A = rng.normal(size=(3, 3)) * 0.5
    B = rng.normal(size=(3, 2))
    f = lambda x, u: jnp.asarray(A, jnp.float32) @ x + jnp.asarray(B, jnp.float32) @ u
    xs = rng.normal(size=(4, 3)).astype(np.float32)
    us = rng.normal(size=(4, 2)).astype(np.float32)
    As, Bs, cs = linearize(f, xs, us)
    tol = 1e-5
    for k in range(4):
        np.testing.assert_allclose(As[k], A, atol=tol)
        np.testing.assert_allclose(Bs[k], B, atol=tol)
    np.testing.assert_allclose(cs, 0.0, atol=tol)


def test_linearization_exact_at_nominal(rng):
    """The affine model (A_k, B_k, c_k) must reproduce the nonlinear
    rollout exactly at the linearization trajectory (defect-free)."""
    f = rk4(pendulum_dynamics(), dt=0.05)
    x0 = np.array([0.3, -0.2], dtype=np.float32)
    us = rng.normal(size=(6, 1)).astype(np.float32) * 0.5
    xs_next = np.asarray(rollout(f, x0, us))
    xs_lin = np.concatenate([x0[None], xs_next[:-1]], axis=0)
    A, B, c = map(np.asarray, linearize(f, xs_lin, us))
    x = x0.astype(np.float64)
    for k in range(6):
        x = A[k] @ x + B[k] @ us[k] + c[k]
        np.testing.assert_allclose(x, xs_next[k], atol=1e-5)


def test_rk4_accuracy():
    """RK4 on xdot = -x over one step matches exp(-dt) to O(dt^5)."""
    f = rk4(lambda x, u: -x + 0.0 * u, dt=0.1)
    x1 = np.asarray(f(jnp.ones(1), jnp.zeros(1)))[0]
    assert abs(x1 - np.exp(-0.1)) < 1e-7


# ------------------------------------------------------------- closed loop


def test_nmpc_pendulum_upright():
    """Swing a damped pendulum from near-hanging to the UPRIGHT (unstable)
    equilibrium under a torque limit — the canonical SL-NMPC demo. An LTI
    controller linearized at the start point cannot do this."""
    dt = 0.05
    f = rk4(pendulum_dynamics(), dt=dt)
    ctrl = NMPC(
        f,
        n_x=2,
        n_u=1,
        horizon=25,
        Q=np.diag([10.0, 1.0]),
        R=np.diag([0.1]),
        u_min=np.array([-11.0]),
        u_max=np.array([11.0]),
        iterations=200,
        sqp_iters=2,
    )
    # 61 deg short of upright: peak gravity torque on the path is
    # mgl sin(2.07) = 8.6, inside the 11.0 limit but using 78% of it
    x0 = np.array([2.07, 0.0])
    X, U = simulate_nonlinear(f, ctrl, x0, n_steps=80, x_ref=UPRIGHT)
    assert np.abs(U).max() <= 11.0 + 1e-3  # torque limit respected
    tail = X[-10:]
    assert np.abs(tail[:, 0] - np.pi).max() < 0.05, tail[-1]
    assert np.abs(tail[:, 1]).max() < 0.1


def test_nmpc_rate_limits():
    """Slew limits hold across samples (u_prev threaded through the QP)."""
    dt = 0.05
    f = rk4(pendulum_dynamics(), dt=dt)
    ctrl = NMPC(
        f,
        n_x=2,
        n_u=1,
        horizon=15,
        Q=np.diag([10.0, 1.0]),
        R=np.diag([0.1]),
        u_min=np.array([-8.0]),
        u_max=np.array([8.0]),
        du_min=np.array([-1.0]),
        du_max=np.array([1.0]),
        iterations=200,
    )
    X, U = simulate_nonlinear(f, ctrl, np.array([2.6, 0.0]), 40, x_ref=UPRIGHT)
    dU = np.diff(np.concatenate([[np.zeros(1)], U], axis=0), axis=0)
    assert np.abs(dU).max() <= 1.0 + 1e-3


def test_nmpc_reset_and_guards():
    f = rk4(pendulum_dynamics(), dt=0.05)
    with pytest.raises(ValueError, match="damping"):
        NMPC(f, 2, 1, 10, np.eye(2), np.eye(1), damping=0.0)
    with pytest.raises(ValueError, match="sqp_iters"):
        NMPC(f, 2, 1, 10, np.eye(2), np.eye(1), sqp_iters=0)
    ctrl = NMPC(f, 2, 1, 10, np.eye(2), np.eye(1), u_min=np.array([-8.0]),
                u_max=np.array([8.0]), iterations=100)
    u = ctrl.step(np.array([0.3, 0.0]))
    assert u.shape == (1,)
    ctrl.reset()
    assert ctrl._us is None and ctrl._y is None


# --------------------------------------------------------------- batch NMPC


def test_nmpc_batch_matches_single():
    """A batch of identical states must plan identically to the single-
    plant path (same linearizations, same QPs, one vmapped solve)."""
    f = rk4(pendulum_dynamics(), dt=0.05)
    kw = dict(
        n_x=2, n_u=1, horizon=12, Q=np.diag([10.0, 1.0]), R=np.diag([0.1]),
        u_min=np.array([-11.0]), u_max=np.array([11.0]), iterations=150,
    )
    single = NMPC(f, **kw)
    batch = NMPC(f, **kw)
    x = np.array([1.8, 0.3], dtype=np.float32)
    for _ in range(3):  # a few samples so warm starts engage
        u1 = single.plan(x, UPRIGHT)
        ub = batch.plan_batch(np.stack([x, x]), UPRIGHT)
    np.testing.assert_allclose(ub[0], ub[1], atol=1e-6)
    np.testing.assert_allclose(ub[0], u1, atol=1e-4)


def test_nmpc_batch_closed_loop():
    """Different start angles all reach upright, planned together."""
    import jax.numpy as jnp

    f = rk4(pendulum_dynamics(), dt=0.05)
    ctrl = NMPC(
        f, n_x=2, n_u=1, horizon=25, Q=np.diag([10.0, 1.0]),
        R=np.diag([0.1]), u_min=np.array([-11.0]), u_max=np.array([11.0]),
        iterations=200, sqp_iters=2,
    )
    X = np.array([[2.07, 0.0], [2.4, 0.0], [2.8, -0.3]], dtype=np.float32)
    for _ in range(80):
        U = ctrl.step_batch(X, UPRIGHT)
        X = np.asarray(jnp.stack([
            f(jnp.asarray(X[b]), jnp.asarray(U[b])) for b in range(3)
        ]))
    assert np.abs(X[:, 0] - np.pi).max() < 0.05, X
    assert np.abs(X[:, 1]).max() < 0.1


def test_nmpc_batch_resets_on_size_change():
    f = rk4(pendulum_dynamics(), dt=0.05)
    ctrl = NMPC(f, 2, 1, 8, np.diag([10.0, 1.0]), np.diag([0.1]),
                u_min=np.array([-11.0]), u_max=np.array([11.0]),
                iterations=100)
    u2 = ctrl.step_batch(np.zeros((2, 2)))
    assert u2.shape == (2, 1)
    u3 = ctrl.step_batch(np.zeros((3, 2)))  # size change: fresh warm start
    assert u3.shape == (3, 1)


# ------------------------------------------------------------ preview NMPC


def test_nmpc_preview_figure_eight():
    """Trajectory-tracking NMPC: a drag point mass follows a figure-eight
    with per-stage reference preview. Preview anticipates the curve; a
    constant-setpoint controller would cut every corner."""
    from tpu_gpad.problems.point_mass import figure_eight, point_mass_drag

    dt = 0.1
    f = rk4(point_mass_drag(k=0.3), dt=dt)
    N = 12
    n_steps = 60
    traj = figure_eight(n_steps + N + 1, dt, scale=1.0, period=6.0)
    ctrl = NMPC(
        f, n_x=4, n_u=2, horizon=N,
        Q=np.diag([20.0, 20.0, 1.0, 1.0]), R=np.diag([0.05, 0.05]),
        u_min=np.full(2, -6.0), u_max=np.full(2, 6.0),
        iterations=200, sqp_iters=2, preview=True,
    )
    X, U = simulate_nonlinear(f, ctrl, traj[0], n_steps, x_ref=traj)
    pos_err = np.linalg.norm(X[1:, :2] - traj[1 : n_steps + 1, :2], axis=1)
    # transient settles, then the mass rides the curve closely
    assert pos_err[10:].max() < 0.08, pos_err[10:].max()
    assert np.abs(U).max() <= 6.0 + 1e-3


def test_nmpc_preview_shapes_and_batch():
    from tpu_gpad.problems.point_mass import point_mass_drag

    f = rk4(point_mass_drag(), dt=0.1)
    ctrl = NMPC(
        f, n_x=4, n_u=2, horizon=6,
        Q=np.eye(4), R=np.eye(2) * 0.1,
        u_min=np.full(2, -6.0), u_max=np.full(2, 6.0),
        iterations=100, preview=True,
    )
    window = np.zeros((6, 4), dtype=np.float32)
    u = ctrl.step(np.zeros(4), window)
    assert u.shape == (2,)
    # batch: shared window and per-scenario windows both accepted
    U = ctrl.step_batch(np.zeros((3, 4)), window)
    assert U.shape == (3, 2)
    U2 = ctrl.step_batch(np.zeros((3, 4)), np.zeros((3, 6, 4)))
    assert U2.shape == (3, 2)


def test_nmpc_stagewise_engine_matches_condensed():
    """NMPC(engine='stagewise'): the O(N) long-horizon SQP path produces
    the same plans as the condensed path (same linearization, same dual
    problem — affine offsets ride the stage-wise dtl/qoff constants),
    and swings the pendulum the same way."""
    pendulum_f = rk4(pendulum_dynamics(), dt=0.05)
    kw = dict(
        f=pendulum_f,
        n_x=2,
        n_u=1,
        horizon=12,
        Q=np.diag([5.0, 0.5]),
        R=np.eye(1) * 0.1,
        u_min=np.array([-2.0]),
        u_max=np.array([2.0]),
        iterations=300,
        sqp_iters=2,
    )
    nm_c = NMPC(**kw)
    nm_s = NMPC(engine="stagewise", **kw)
    x = np.array([np.pi * 0.8, 0.0], dtype=np.float32)
    ref = np.zeros(2, dtype=np.float32)
    for t in range(4):
        us_c = nm_c.plan(x, ref)
        us_s = nm_s.plan(x, ref)
        np.testing.assert_allclose(us_s, us_c, atol=2e-3)
        x = np.asarray(
            pendulum_f(jnp.asarray(x), jnp.asarray(us_c[0])),
            dtype=np.float32,
        ).reshape(2)

    with pytest.raises(ValueError, match="rate limits"):
        NMPC(engine="stagewise", du_min=np.array([-0.1]),
             du_max=np.array([0.1]), **kw)


def test_nmpc_stagewise_plan_batch_matches_condensed():
    """plan_batch on the stage-wise engine (stack_stagewise +
    solve_stagewise_multi, VERDICT r04 item 2 tail): B scenarios, each
    linearized along its own trajectory, match the condensed plan_batch
    — and warm-start state carries across calls."""
    pendulum_f = rk4(pendulum_dynamics(), dt=0.05)
    kw = dict(
        f=pendulum_f, n_x=2, n_u=1, horizon=10, Q=np.diag([5.0, 0.5]),
        R=np.eye(1) * 0.1, u_min=np.array([-2.0]), u_max=np.array([2.0]),
        iterations=300, sqp_iters=2,
    )
    nm_c = NMPC(**kw)
    nm_s = NMPC(engine="stagewise", **kw)
    rng = np.random.default_rng(0)
    X = rng.uniform(-0.5, 0.5, size=(3, 2)).astype(np.float32) + np.array(
        [np.pi * 0.7, 0.0], dtype=np.float32)
    ref = np.zeros(2, dtype=np.float32)
    for _ in range(2):  # second call exercises the warm-started path
        U_c = nm_c.plan_batch(X, ref)
        U_s = nm_s.plan_batch(X, ref)
        np.testing.assert_allclose(U_s, U_c, atol=5e-3)
    assert nm_s._y_b is not None
    # batch-size change resets the warm start rather than crashing
    U2 = nm_s.plan_batch(X[:2], ref)
    assert U2.shape == (2, 10, 1)

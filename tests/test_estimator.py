"""Output-feedback / offset-free MPC: disturbance-augmented Kalman filter,
steady-state target calculation, and the zero-offset closed loop — the
production layer the reference's full-state-feedback loop (gpad.m:91-93)
lacks."""

import numpy as np
import pytest

import tpu_gpad

from tpu_gpad import problems
from tpu_gpad.estimator import (
    KalmanFilter,
    OffsetFreeController,
    TargetCalculator,
    augment_disturbance,
    kalman_gain,
)
from tpu_gpad.solver import SolverConfig


def _di():
    return problems.double_integrator(horizon=10)


def test_kalman_gain_is_stabilizing():
    prob = _di()
    C = np.array([[1.0, 0.0]])
    L = kalman_gain(prob.A, C, np.eye(2) * 1e-3, np.eye(1) * 1e-4)
    # filter error dynamics (I - LC) A must be Schur stable
    err_dyn = (np.eye(2) - L @ C) @ prob.A
    assert np.abs(np.linalg.eigvals(err_dyn)).max() < 1.0


def test_kalman_filter_converges_to_true_state():
    """Noise-free plant, unknown initial state: the estimate converges to
    the true state and the disturbance estimate to zero."""
    prob = _di()
    C = np.array([[1.0, 0.0]])
    # input-disturbance model (an output disturbance on an integrating
    # plant is undetectable — augment_disturbance would reject it)
    Bd = np.asarray(prob.B)
    Cd = np.zeros((1, 1))
    kf = KalmanFilter(prob.A, prob.B, C, Bd, Cd)  # filter starts at 0
    rng = np.random.default_rng(0)
    x = np.array([1.0, -0.3])
    u_prev = np.zeros(1)
    for _ in range(100):
        x = prob.A @ x + prob.B @ u_prev  # plant moves first...
        x_hat, d_hat = kf.update(C @ x, u_prev)  # ...filter sees its output
        u_prev = rng.uniform(-0.5, 0.5, 1)
    assert np.abs(x_hat - x).max() < 1e-2, (x_hat, x)
    assert np.abs(d_hat).max() < 1e-2


def test_augment_rejects_undetectable_model():
    prob = _di()
    C = np.array([[1.0, 0.0]])
    # two output disturbances on one output: undetectable (n_d > n_y)
    Bd = np.zeros((2, 2))
    Cd = np.array([[1.0, 1.0]])
    with pytest.raises(ValueError, match="undetectable"):
        augment_disturbance(prob.A, prob.B, C, Bd, Cd)


def test_target_calculator_square_case():
    prob = _di()
    C = np.array([[1.0, 0.0]])
    Bd = np.asarray(prob.B)
    Cd = np.zeros((1, 1))
    tc = TargetCalculator(prob.A, prob.B, C, Bd, Cd)
    d = np.array([0.07])
    r = np.array([2.0])
    x_ss, u_ss = tc(r, d)
    # steady state: x_ss = A x_ss + B (u_ss + d), y_ss = C x_ss = r
    resid = (prob.A - np.eye(2)) @ x_ss + prob.B @ u_ss + Bd @ d
    assert np.abs(resid).max() < 1e-10
    assert abs(C @ x_ss - r) < 1e-10
    # input disturbance must be countered one-for-one at steady state
    # (double integrator: u_ss + d = 0 keeps velocity constant)
    assert abs(u_ss[0] + d[0]) < 1e-10


def test_offset_free_rejects_input_disturbance():
    """Plant applies u + d_true with unknown constant d_true. The
    input-disturbance offset-free controller drives the measured output to
    the setpoint anyway; a plain (certainty-equivalence, no disturbance
    model) tracking controller is left with a steady-state offset."""
    prob = _di()
    C = np.array([[1.0, 0.0]])
    d_true = 0.08
    r = np.array([1.5])
    cfg = SolverConfig(iterations=80, restart=True)

    off = OffsetFreeController(prob, C, disturbance="input", config=cfg)
    x = np.zeros(2)
    for _ in range(120):
        y = C @ x
        u = off.step(y, r)
        x = prob.A @ x + prob.B @ (u.astype(np.float64) + d_true)
    assert abs(C @ x - r)[0] < 1e-3, (C @ x, r)
    assert abs(off.d_hat[0] - d_true) < 1e-3  # disturbance identified

    # plain tracking controller fed the true state, no disturbance model
    plain = tpu_gpad.Controller(prob, tracking=True, config=cfg)
    x = np.zeros(2)
    for _ in range(120):
        u = plain.step(x.astype(np.float32), x_ref=np.array([r[0], 0.0], np.float32))
        x = prob.A @ x + prob.B @ (u.astype(np.float64) + d_true)
    assert abs(C @ x - r)[0] > 5e-3  # visible offset remains


def test_offset_free_rejects_output_bias():
    """Measurement carries a constant bias; the output-disturbance model
    identifies it and the MEASURED output settles on the setpoint.
    Needs a strictly stable plant — on an integrator the output
    disturbance is undetectable (see test_augment_rejects...)."""
    prob = tpu_gpad.LinearMPCProblem(
        A=np.array([[0.9]]),
        B=np.array([[1.0]]),
        Q=np.eye(1),
        R=np.eye(1) * 0.1,
        horizon=8,
        u_min=np.array([-2.0]),
        u_max=np.array([2.0]),
        name="stable1d",
    )
    C = np.array([[1.0]])
    bias = -0.12
    r = np.array([0.8])
    off = OffsetFreeController(
        prob, C, disturbance="output",
        config=SolverConfig(iterations=80, restart=True),
    )
    x = np.zeros(1)
    for _ in range(150):
        y = C @ x + bias
        u = off.step(y, r)
        x = prob.A @ x + prob.B @ u.astype(np.float64)
    # the controller trusts y - d_hat: the MEASURED output converges to r
    assert abs((C @ x + bias) - r)[0] < 1e-3
    assert abs(off.d_hat[0] - bias) < 1e-3


def test_offset_free_with_model_mismatch():
    """Plant A differs from the model (friction term): the integrating
    disturbance absorbs the mismatch at steady state — still zero offset."""
    prob = _di()
    A_plant = np.asarray(prob.A).copy()
    A_plant[1, 1] = 0.97  # velocity damping the model does not know about
    C = np.array([[1.0, 0.0]])
    r = np.array([1.0])
    off = OffsetFreeController(
        prob, C, disturbance="input",
        config=SolverConfig(iterations=80, restart=True),
    )
    x = np.zeros(2)
    for _ in range(200):
        y = C @ x
        u = off.step(y, r)
        x = A_plant @ x + np.asarray(prob.B) @ u.astype(np.float64)
    assert abs(C @ x - r)[0] < 2e-3, C @ x


def test_offset_free_noisy_measurements():
    """With process + measurement noise the loop settles near the setpoint
    (bounded by the noise floor, not by a bias)."""
    prob = _di()
    C = np.array([[1.0, 0.0]])
    d_true = 0.05
    r = np.array([1.0])
    rng = np.random.default_rng(3)
    off = OffsetFreeController(
        prob, C, disturbance="input",
        W=np.eye(2) * 1e-4, V=np.eye(1) * 1e-4,
        config=SolverConfig(iterations=80, restart=True),
    )
    x = np.zeros(2)
    tail = []
    for t in range(400):
        y = C @ x + rng.normal(0, 1e-2, 1)
        u = off.step(y, r)
        x = prob.A @ x + prob.B @ (u.astype(np.float64) + d_true)
        x += rng.normal(0, 1e-3, 2)
        if t >= 300:
            tail.append((C @ x - r)[0])
    assert abs(np.mean(tail)) < 2e-2, np.mean(tail)


def test_process_disturbance_condensing_matches_hand_built():
    """condense(process_disturbance=True): predictions x = T x0 + S z + S_c c
    shift both the tracking cost and the state-box RHS — checked against a
    hand-expanded QP through the same exact solver."""
    from tpu_gpad.condense import prediction_matrices
    from tpu_gpad.solver.qp import solve_condensed_qp, solve_qp_exact

    prob = _di()
    n_x, n_u, N = prob.n_x, prob.n_u, prob.horizon
    qp = tpu_gpad.condense(
        prob, tracking=True, input_reference=True, process_disturbance=True
    )
    assert qp.n_x == 2 * n_x + n_u + n_x
    assert "_dist" in qp.name
    T, S = prediction_matrices(prob.A, prob.B, N)
    # S_c blocks: partial sums of A^j
    power = np.eye(n_x)
    total = np.zeros((n_x, n_x))
    blocks = []
    for _ in range(N):
        total = total + power
        blocks.append(total.copy())
        power = np.asarray(prob.A) @ power
    S_c = np.concatenate(blocks, axis=0)
    Qbar = np.kron(np.eye(N), prob.Q)
    Rbar = np.kron(np.eye(N), prob.R)
    H = S.T @ Qbar @ S + Rbar
    rng = np.random.default_rng(5)
    for _ in range(4):
        x0 = rng.uniform(-2, 2, n_x)
        r = rng.uniform(-1, 1, n_x)
        u_r = rng.uniform(-0.2, 0.2, n_u)
        c = rng.uniform(-0.05, 0.05, n_x)
        p = np.concatenate([x0, r, u_r, c])
        sol = solve_condensed_qp(qp, p)
        f = S.T @ Qbar @ (T @ x0 + S_c @ c - np.tile(r, N)) - np.tile(
            prob.R @ u_r, N
        )
        # hand-built constraints: state boxes see the shifted predictions
        xmax = np.tile(np.asarray(prob.x_max), N)
        xmin = np.tile(np.asarray(prob.x_min), N)
        G = np.concatenate([S, -S, np.eye(n_u * N), -np.eye(n_u * N)])
        rhs = np.concatenate(
            [
                xmax - T @ x0 - S_c @ c,
                -xmin + T @ x0 + S_c @ c,
                np.tile(np.asarray(prob.u_max), N),
                -np.tile(np.asarray(prob.u_min), N),
            ]
        )
        sol2 = solve_qp_exact(H, f, G, rhs)
        assert sol.status == sol2.status == "optimal"
        np.testing.assert_allclose(sol.z, sol2.z, atol=1e-8)


def test_reset_clears_estimates():
    prob = _di()
    C = np.array([[1.0, 0.0]])
    off = OffsetFreeController(prob, C, disturbance="input",
                               config=SolverConfig(iterations=40))
    off.step(np.array([0.5]), np.array([1.0]))
    assert np.abs(off.filter.xa).max() > 0
    off.reset()
    assert np.abs(off.filter.xa).max() == 0
    assert np.abs(off._u_last).max() == 0


# --------------------------------------------------------------------- EKF


def test_ekf_linear_matches_kf_recursion(rng):
    """On a LINEAR system the EKF must reproduce the textbook time-varying
    Kalman recursion exactly (Jacobians are the matrices)."""
    import jax.numpy as jnp
    from tpu_gpad.estimator import ExtendedKalmanFilter

    A = np.array([[0.9, 0.2], [0.0, 0.8]])
    B = np.array([[0.0], [0.5]])
    C = np.array([[1.0, 0.0]])
    W, V = np.eye(2) * 1e-3, np.eye(1) * 1e-4
    f = lambda x, u: jnp.asarray(A, jnp.float32) @ x + jnp.asarray(B, jnp.float32) @ u
    h = lambda x: jnp.asarray(C, jnp.float32) @ x
    ekf = ExtendedKalmanFilter(f, h, n_x=2, n_y=1, W=W, V=V)
    # reference recursion in float64
    x_ref, P_ref = np.zeros(2), np.eye(2)
    for t in range(20):
        u = np.array([np.sin(0.3 * t)])
        y = np.array([0.5 + 0.1 * t])
        x_hat = ekf.update(y, u)
        x_pred = A @ x_ref + B @ u
        P_pred = A @ P_ref @ A.T + W
        S = C @ P_pred @ C.T + V
        K = P_pred @ C.T @ np.linalg.inv(S)
        x_ref = x_pred + K @ (y - C @ x_pred)
        IKH = np.eye(2) - K @ C
        P_ref = IKH @ P_pred @ IKH.T + K @ V @ K.T
        np.testing.assert_allclose(
            x_hat, x_ref, atol=1e-4)
    np.testing.assert_allclose(ekf.P, P_ref, atol=1e-5)


def test_ekf_pendulum_state_reconstruction():
    """Measuring only the angle, the EKF must reconstruct the angular
    velocity of a freely swinging pendulum."""
    import jax.numpy as jnp
    from tpu_gpad.estimator import ExtendedKalmanFilter
    from tpu_gpad.nonlinear import rk4
    from tpu_gpad.problems.pendulum import pendulum_dynamics

    f = rk4(pendulum_dynamics(), dt=0.05)
    h = lambda x: x[:1]
    ekf = ExtendedKalmanFilter(
        f, h, n_x=2, n_y=1, x0=np.array([0.5, 0.0])  # wrong omega guess
    )
    x_true = np.array([0.5, 1.0], dtype=np.float32)  # true omega = 1.0
    u0 = np.zeros(1, dtype=np.float32)
    for _ in range(40):
        x_true = np.asarray(f(jnp.asarray(x_true), jnp.asarray(u0)))
        x_hat = ekf.update(x_true[:1], u0)
    # initial omega error is 1.0; the filter's steady-state error with
    # W = 1e-3 I sits at a few e-3 — assert the 100x reduction
    np.testing.assert_allclose(x_hat, x_true, atol=1e-2)


def test_output_feedback_nmpc_pendulum():
    """EKF + NMPC from angle measurements only: the pendulum still reaches
    the upright equilibrium (the output-feedback nonlinear loop)."""
    import jax.numpy as jnp
    from tpu_gpad.estimator import ExtendedKalmanFilter
    from tpu_gpad.nonlinear import NMPC, rk4
    from tpu_gpad.problems.pendulum import UPRIGHT, pendulum_dynamics

    f = rk4(pendulum_dynamics(), dt=0.05)
    h = lambda x: x[:1]
    x0_true = np.array([2.07, 0.0], dtype=np.float32)
    ekf = ExtendedKalmanFilter(
        f, h, n_x=2, n_y=1, x0=np.array([2.0, 0.0])  # imperfect initial guess
    )
    ctrl = NMPC(
        f, n_x=2, n_u=1, horizon=25,
        Q=np.diag([10.0, 1.0]), R=np.diag([0.1]),
        u_min=np.array([-11.0]), u_max=np.array([11.0]),
        iterations=200, sqp_iters=2,
    )
    x = x0_true
    u = np.zeros(1, dtype=np.float32)
    thetas = []
    for _ in range(80):
        x_hat = ekf.update(x[:1], u)  # angle measurement only
        u = ctrl.step(x_hat.astype(np.float32), UPRIGHT)
        x = np.asarray(f(jnp.asarray(x), jnp.asarray(u)))
        thetas.append(float(x[0]))
    assert abs(thetas[-1] - np.pi) < 0.05, thetas[-1]

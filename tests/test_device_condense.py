"""Device-side (jittable) condensation vs the float64 host pipeline."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tpu_gpad
from tpu_gpad.condense import prediction_matrices_ltv
from tpu_gpad.device_condense import (
    dualize_ltv_device,
    prediction_matrices_device,
)
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.types import LinearMPCProblem


def _ltv(N=6, n_x=3, n_u=2, seed=0):
    rng = np.random.default_rng(seed)
    A = np.stack([
        np.eye(n_x) + 0.08 * rng.standard_normal((n_x, n_x)) for _ in range(N)
    ])
    B = 0.4 * rng.standard_normal((N, n_x, n_u))
    c = 0.02 * rng.standard_normal((N, n_x))
    return A, B, c


def _host_data(A, B, c, Q, R, bounds, iterations, preview=False):
    problem = LinearMPCProblem(
        A=A, B=B, Q=Q, R=R, horizon=A.shape[0], c=c, **bounds
    )
    qp = tpu_gpad.condense(
        problem, tracking="preview" if preview else True
    )
    return tpu_gpad.dualize(qp, iterations=iterations, paired=True)


BOUNDS = dict(
    x_min=np.full(3, -2.0), x_max=np.full(3, 2.0),
    u_min=np.full(2, -1.0), u_max=np.full(2, 1.0),
)


def test_prediction_matrices_match_host():
    A, B, _ = _ltv()
    T_h, S_h = prediction_matrices_ltv(A, B)
    T_d, S_d = prediction_matrices_device(
        jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32)
    )
    tol = 1e-5
    np.testing.assert_allclose(np.asarray(T_d), T_h, atol=tol)
    np.testing.assert_allclose(np.asarray(S_d), S_h, atol=tol)


def test_gpaddata_matches_host_layout():
    A, B, c = _ltv()
    Q, R = np.eye(3), 0.5 * np.eye(2)
    host = _host_data(A, B, c, Q, R, BOUNDS, iterations=100)
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c), Q, R,
        BOUNDS["u_min"], BOUNDS["u_max"], iterations=100,
        x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"],
    )
    assert dev.paired and dev.n_struct == host.n_struct == 18
    assert dev.m_half == host.m_half
    # L-independent operands agree to fp32 accuracy, same row order
    tol_op = 2e-4
    np.testing.assert_allclose(
        np.asarray(dev.MG_T), np.asarray(host.MG_T), atol=tol_op
    )
    np.testing.assert_allclose(
        np.asarray(dev.gP_map), np.asarray(host.gP_map), atol=tol_op
    )
    np.testing.assert_allclose(
        np.asarray(dev.gP_const), np.asarray(host.gP_const), atol=tol_op
    )
    # L: power-method Rayleigh estimate with 5% margin (capped by the
    # certified row-sum bound) vs the exact eigensolve
    L_h, L_d = float(np.asarray(host.L)), float(np.asarray(dev.L))
    assert 0.999 * L_h <= L_d <= 1.10 * L_h
    # L-scaled operands agree after rescaling
    np.testing.assert_allclose(
        np.asarray(dev.D) * L_d, np.asarray(host.D) * L_h,
        atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(dev.pD_const) * L_d,
        np.asarray(host.pD_const) * L_h, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(dev.pD_map) * L_d,
        np.asarray(host.pD_map) * L_h, atol=1e-4,
    )


@pytest.mark.parametrize("preview", [False, True])
def test_solutions_match_host_pipeline(preview):
    A, B, c = _ltv(seed=3)
    Q, R = np.eye(3), 0.5 * np.eye(2)
    host = _host_data(A, B, c, Q, R, BOUNDS, 2000, preview=preview)
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c), Q, R,
        BOUNDS["u_min"], BOUNDS["u_max"], iterations=2000,
        x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"], preview=preview,
    )
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.5, 0.5, size=3)
    r = (rng.uniform(-0.3, 0.3, size=6 * 3) if preview
         else rng.uniform(-0.3, 0.3, size=3))
    p = np.concatenate([x0, r]).astype(np.float32)[None]
    cfg = SolverConfig(mode="eps", eps_g=1e-6, eps_V=1e-6, iterations=2000,
                       restart=True)
    r_h = solve_batch(host, p, config=cfg)
    r_d = solve_batch(dev, p, config=cfg)
    assert np.asarray(r_h.converged).all() and np.asarray(r_d.converged).all()
    np.testing.assert_allclose(
        np.asarray(r_d.u), np.asarray(r_h.u), atol=2e-3
    )


def test_no_state_box_variant():
    A, B, c = _ltv(seed=7)
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
        np.eye(3), np.eye(2), np.full(2, -1.0), np.full(2, 1.0),
        iterations=200,
    )
    assert dev.n_struct == 0 and dev.m_half == 12
    p = np.zeros((1, 6), np.float32)
    res = solve_batch(dev, p, config=SolverConfig(iterations=200))
    assert np.isfinite(np.asarray(res.u)).all()


def test_jit_and_vmap_composition():
    """The whole condense+dualize+solve is one jitted, vmappable program."""
    Q, R = np.eye(3), 0.5 * np.eye(2)
    cfg = SolverConfig(iterations=150)

    @jax.jit
    def plan(A, B, c, p):
        data = dualize_ltv_device(
            A, B, c, Q, R, BOUNDS["u_min"], BOUNDS["u_max"], iterations=150,
            x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"],
        )
        return solve_batch(data, p[None], config=cfg).u[0]

    A, B, c = _ltv(seed=9)
    p = np.concatenate([[0.2, -0.1, 0.3], np.zeros(3)]).astype(np.float32)
    u_jit = plan(jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32),
                 jnp.asarray(c, jnp.float32), jnp.asarray(p))
    host = _host_data(A, B, c, Q, R, BOUNDS, 150)
    u_host = solve_batch(host, p[None], config=cfg).u[0]
    np.testing.assert_allclose(np.asarray(u_jit), np.asarray(u_host),
                               atol=5e-3)

    # vmap over B independent linearizations (the NMPC batch case)
    As, Bs, cs, ps = [], [], [], []
    for s in range(3):
        A, B, c = _ltv(seed=20 + s)
        As.append(A); Bs.append(B); cs.append(c)
        ps.append(np.concatenate(
            [np.full(3, 0.1 * (s + 1)), np.zeros(3)]).astype(np.float32))

    @jax.jit
    def plan_many(A, B, c, p):
        return jax.vmap(plan)(A, B, c, p)

    U = plan_many(
        jnp.asarray(np.stack(As), jnp.float32),
        jnp.asarray(np.stack(Bs), jnp.float32),
        jnp.asarray(np.stack(cs), jnp.float32),
        jnp.asarray(np.stack(ps)),
    )
    for s in range(3):
        u_one = plan(jnp.asarray(As[s], jnp.float32),
                     jnp.asarray(Bs[s], jnp.float32),
                     jnp.asarray(cs[s], jnp.float32), jnp.asarray(ps[s]))
        np.testing.assert_allclose(np.asarray(U[s]), np.asarray(u_one),
                                   atol=1e-5)


@pytest.mark.parametrize(
    "N,n_x,n_u,seed", [(4, 2, 1, 11), (8, 3, 2, 12), (5, 4, 3, 13)]
)
def test_device_vs_host_shape_fuzz(N, n_x, n_u, seed):
    """Device condensation vs the float64 host pipeline across random
    shapes: converged eps-restart solutions must agree."""
    rng = np.random.default_rng(seed)
    A = np.stack([
        np.eye(n_x) + 0.1 * rng.standard_normal((n_x, n_x)) for _ in range(N)
    ])
    B = 0.5 * rng.standard_normal((N, n_x, n_u))
    c = 0.02 * rng.standard_normal((N, n_x))
    bounds = dict(
        x_min=np.full(n_x, -3.0), x_max=np.full(n_x, 3.0),
        u_min=np.full(n_u, -1.0), u_max=np.full(n_u, 1.0),
    )
    Q, R = np.eye(n_x), 0.3 * np.eye(n_u)
    host = _host_data(A, B, c, Q, R, bounds, 3000)
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c), Q, R,
        bounds["u_min"], bounds["u_max"], iterations=3000,
        x_min=bounds["x_min"], x_max=bounds["x_max"],
    )
    p = np.concatenate([
        rng.uniform(-0.5, 0.5, n_x), rng.uniform(-0.3, 0.3, n_x)
    ]).astype(np.float32)[None]
    cfg = SolverConfig(mode="eps", eps_g=1e-6, eps_V=1e-6, iterations=3000,
                       restart=True)
    r_h = solve_batch(host, p, config=cfg)
    r_d = solve_batch(dev, p, config=cfg)
    assert np.asarray(r_h.converged).all() and np.asarray(r_d.converged).all()
    np.testing.assert_allclose(
        np.asarray(r_d.u), np.asarray(r_h.u), atol=2e-3
    )


def test_power_lmax_dominant_mode_orthogonal_to_ones():
    """Symmetric plants put the top dual mode orthogonal to 1; the power
    method must not lock onto a sub-dominant eigenvalue (an all-ones
    start once did exactly that, underestimating L)."""
    from tpu_gpad.device_condense import _power_lmax

    n = 16
    v_top = np.ones(n)
    v_top[: n // 2] = -1.0  # mean-free: orthogonal to the ones vector
    v_top /= np.linalg.norm(v_top)
    rng = np.random.default_rng(2)
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # force v_top to be the dominant eigenvector
    basis = np.concatenate([v_top[:, None], Qm[:, :0]], axis=1)
    rest = Qm - Qm @ v_top[:, None] @ v_top[None, :]
    rest_q, _ = np.linalg.qr(rest)
    vecs = np.concatenate([v_top[:, None], rest_q[:, : n - 1]], axis=1)
    vals = np.concatenate([[1.0], 0.9 * rng.uniform(0.1, 1.0, n - 1)])
    M = (vecs * vals) @ vecs.T
    est, resid = _power_lmax(jnp.asarray(M, jnp.float32))
    assert float(est) > 0.97  # locked onto the dominant mode, not 0.9-scaled
    assert float(resid) < 0.02  # converged: the caller may trust the estimate


def test_power_lmax_residual_flags_nonconvergence():
    """With a tiny eigengap and too few iterations, the Rayleigh estimate
    underestimates lambda_max — the residual must flag it so dualize falls
    back to the certified inf-norm bound (ADVICE round 2)."""
    from tpu_gpad.device_condense import _power_lmax

    n = 32
    rng = np.random.default_rng(5)
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    vals = np.concatenate([[1.0, 0.999], rng.uniform(0.1, 0.9, n - 2)])
    M = (Qm * vals) @ Qm.T
    _, resid_short = _power_lmax(jnp.asarray(M, jnp.float32), iters=2)
    assert float(resid_short) > 0.02  # not converged -> certified fallback


def _pendulum_nmpc(device_condense, sqp_iters=2):
    from tpu_gpad.nonlinear import NMPC, rk4

    def f_cont(x, u):
        th, om = x
        return jnp.array([om, 9.81 * jnp.sin(th) - 0.1 * om + u[0]])

    return NMPC(
        rk4(f_cont, 0.05), n_x=2, n_u=1, horizon=12,
        Q=np.diag([10.0, 1.0]), R=0.1 * np.eye(1),
        x_min=np.array([-10.0, -12.0]), x_max=np.array([10.0, 12.0]),
        u_min=np.array([-11.0]), u_max=np.array([11.0]),
        iterations=150, sqp_iters=sqp_iters,
        device_condense=device_condense,
    )


def test_nmpc_device_path_matches_host():
    """The fused device NMPC pass tracks the host-condensed controller."""
    from tpu_gpad.nonlinear import simulate_nonlinear

    ref = np.array([np.pi, 0.0], dtype=np.float32)
    host = _pendulum_nmpc(False)
    dev = _pendulum_nmpc(True)
    x0 = np.array([2.2, 0.0], dtype=np.float32)
    plant = host.f
    X_h, U_h = simulate_nonlinear(plant, host, x0, 40, x_ref=ref)
    X_d, U_d = simulate_nonlinear(plant, dev, x0, 40, x_ref=ref)
    # both settle at the upright equilibrium
    assert abs(X_h[-1, 0] - np.pi) < 0.05
    assert abs(X_d[-1, 0] - np.pi) < 0.05
    # and the trajectories track each other (fp32 vs f64 condensation)
    np.testing.assert_allclose(X_d[:10], X_h[:10], atol=5e-2)


def test_nmpc_device_batch_matches_single():
    dev = _pendulum_nmpc(True, sqp_iters=1)
    X = np.array([[2.0, 0.0], [2.6, -0.5], [3.0, 0.2]], dtype=np.float32)
    ref = np.array([np.pi, 0.0], dtype=np.float32)
    U_b = dev.plan_batch(X, x_ref=ref)
    dev_single = _pendulum_nmpc(True, sqp_iters=1)
    for s in range(3):
        u_s = dev_single.plan(X[s], x_ref=ref)
        dev_single.reset()
        np.testing.assert_allclose(U_b[s], u_s, atol=1e-4)


def test_simulate_nonlinear_device_matches_host_loop():
    """The single-call scanned closed loop == the per-sample host loop
    driving the SAME device-condensed controller."""
    from tpu_gpad.nonlinear import simulate_nonlinear, simulate_nonlinear_device

    ref = np.array([np.pi, 0.0], dtype=np.float32)
    x0 = np.array([2.2, 0.0], dtype=np.float32)
    dev_loop = _pendulum_nmpc(True, sqp_iters=1)
    plant = dev_loop.f
    X_scan, U_scan = simulate_nonlinear_device(plant, dev_loop, x0, 45, x_ref=ref)
    dev_host = _pendulum_nmpc(True, sqp_iters=1)
    X_host, U_host = simulate_nonlinear(plant, dev_host, x0, 45, x_ref=ref)
    np.testing.assert_allclose(X_scan, X_host, atol=1e-4)
    np.testing.assert_allclose(U_scan, U_host, atol=1e-4)
    assert abs(X_scan[-1, 0] - np.pi) < 0.1


def test_simulate_nonlinear_device_requires_flag():
    from tpu_gpad.nonlinear import simulate_nonlinear_device

    host = _pendulum_nmpc(False)
    with pytest.raises(ValueError, match="device_condense"):
        simulate_nonlinear_device(host.f, host, np.zeros(2), 5)


def test_rate_limited_solutions_match_host():
    """Slew rows on the device path: converged solutions match the host
    pipeline (parameter gains trailing u_prev)."""
    A, B, c = _ltv(seed=13)
    Q, R = np.eye(3), 0.5 * np.eye(2)
    du = dict(du_min=np.full(2, -0.3), du_max=np.full(2, 0.3))
    host = _host_data(A, B, c, Q, R, {**BOUNDS, **du}, 2000)
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c), Q, R,
        BOUNDS["u_min"], BOUNDS["u_max"], iterations=2000,
        x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"],
        du_min=du["du_min"], du_max=du["du_max"],
    )
    assert dev.m_half == host.m_half and dev.n_x == host.n_x
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-0.4, 0.4, size=3)
    r = rng.uniform(-0.2, 0.2, size=3)
    u_prev = rng.uniform(-0.5, 0.5, size=2)
    p = np.concatenate([x0, r, u_prev]).astype(np.float32)[None]
    cfg = SolverConfig(mode="eps", eps_g=1e-6, eps_V=1e-6, iterations=2000,
                       restart=True)
    r_h = solve_batch(host, p, config=cfg)
    r_d = solve_batch(dev, p, config=cfg)
    assert np.asarray(r_h.converged).all() and np.asarray(r_d.converged).all()
    np.testing.assert_allclose(
        np.asarray(r_d.u), np.asarray(r_h.u), atol=2e-3
    )
    # the slew constraint binds on the first move from this u_prev
    u0 = np.asarray(r_d.u[0], dtype=np.float64)
    assert (np.abs(u0 - u_prev) <= 0.3 + 1e-4).all()


def test_coupling_solutions_match_host():
    """K_u input-coupling rows (the battery charge-conservation class) on
    the device path: the BATTERY problem itself, expressed as tiled LTV
    stacks, matches the host pipeline and respects sum(u) = 0."""
    from tpu_gpad import problems

    prob = problems.battery(n_cells=3, horizon=5)
    N = prob.horizon
    A = np.repeat(prob.A[None], N, axis=0)
    B = np.repeat(prob.B[None], N, axis=0)
    c = np.zeros((N, prob.n_x))
    host = _host_data(
        A, B, c, prob.Q, prob.R,
        dict(x_min=prob.x_min, x_max=prob.x_max,
             u_min=prob.u_min, u_max=prob.u_max, K_u=prob.K_u),
        2000,
    )
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c), prob.Q, prob.R,
        prob.u_min, prob.u_max, iterations=2000,
        x_min=prob.x_min, x_max=prob.x_max, K_u=prob.K_u,
    )
    assert dev.m_half == host.m_half
    x0 = np.array([0.3, -0.25, 0.05])
    p = np.concatenate([x0, np.zeros(3)]).astype(np.float32)[None]
    cfg = SolverConfig(mode="eps", eps_g=1e-6, eps_V=1e-6, iterations=2000,
                       restart=True)
    r_h = solve_batch(host, p, config=cfg)
    r_d = solve_batch(dev, p, config=cfg)
    assert np.asarray(r_h.converged).all() and np.asarray(r_d.converged).all()
    np.testing.assert_allclose(
        np.asarray(r_d.u), np.asarray(r_h.u), atol=2e-3
    )
    z = np.asarray(r_d.z[0]).reshape(N, prob.n_u)
    np.testing.assert_allclose(z.sum(axis=1), 0.0, atol=1e-4)


def test_nmpc_device_rate_limits_closed_loop():
    """Slew limits hold through the fused device NMPC (host-loop parity)."""
    from tpu_gpad.nonlinear import NMPC, rk4, simulate_nonlinear_device

    def f_cont(x, u):
        th, om = x
        return jnp.array([om, 9.81 * jnp.sin(th) - 0.1 * om + u[0]])

    ctrl = NMPC(
        rk4(f_cont, 0.05), n_x=2, n_u=1, horizon=12,
        Q=np.diag([10.0, 1.0]), R=0.1 * np.eye(1),
        x_min=np.array([-10.0, -12.0]), x_max=np.array([10.0, 12.0]),
        u_min=np.array([-11.0]), u_max=np.array([11.0]),
        du_min=np.array([-2.0]), du_max=np.array([2.0]),
        iterations=200, sqp_iters=1, device_condense=True,
    )
    ref = np.array([np.pi, 0.0], dtype=np.float32)
    X, U = simulate_nonlinear_device(
        ctrl.f, ctrl, np.array([2.4, 0.0], np.float32), 35, x_ref=ref
    )
    dU = np.diff(np.concatenate([[np.zeros(1)], U], axis=0), axis=0)
    assert np.abs(dU).max() <= 2.0 + 1e-3
    assert abs(X[-1, 0] - np.pi) < 0.15


def test_scan_loop_seeds_u_prev_from_reset():
    """simulate_nonlinear_device must honor reset(u_prev=...) for the
    first slew constraint, like the host loop."""
    from tpu_gpad.nonlinear import NMPC, rk4, simulate_nonlinear_device

    def f_cont(x, u):
        th, om = x
        return jnp.array([om, 9.81 * jnp.sin(th) - 0.1 * om + u[0]])

    def make():
        return NMPC(
            rk4(f_cont, 0.05), n_x=2, n_u=1, horizon=10,
            Q=np.diag([10.0, 1.0]), R=0.1 * np.eye(1),
            u_min=np.array([-11.0]), u_max=np.array([11.0]),
            du_min=np.array([-1.0]), du_max=np.array([1.0]),
            iterations=150, sqp_iters=1, device_condense=True,
        )

    x0 = np.array([2.4, 0.0], np.float32)
    ref = np.array([np.pi, 0.0], np.float32)
    c1 = make()
    c1.reset(u_prev=np.array([5.0]))
    _, U1 = simulate_nonlinear_device(c1.f, c1, x0, 3, x_ref=ref)
    # first move is slew-limited against the actuator's REAL position
    assert abs(U1[0, 0] - 5.0) <= 1.0 + 1e-3
    c0 = make()
    _, U0 = simulate_nonlinear_device(c0.f, c0, x0, 3, x_ref=ref)
    assert abs(U0[0, 0]) <= 1.0 + 1e-3
    assert abs(U1[0, 0] - U0[0, 0]) > 0.5  # the seed actually mattered


def test_nmpc_device_validation():
    from tpu_gpad.nonlinear import NMPC, rk4

    f = rk4(lambda x, u: jnp.array([x[1], u[0]]), 0.1)
    with pytest.raises(ValueError, match="input boxes"):
        NMPC(f, n_x=2, n_u=1, horizon=5, Q=np.eye(2), R=np.eye(1),
             device_condense=True)
    # soft_state without a state box is rejected at first pass build
    with pytest.raises(ValueError, match="no state box"):
        NMPC(f, n_x=2, n_u=1, horizon=5, Q=np.eye(2), R=np.eye(1),
             u_min=np.array([-1.0]), u_max=np.array([1.0]),
             soft_state=10.0, device_condense=True)._dev_pass(
                 jnp.zeros(2), jnp.zeros((5, 1)), jnp.zeros(2),
                 jnp.zeros((2, 5)))


def test_validation():
    A, B, c = _ltv()
    with pytest.raises(ValueError, match="input boxes"):
        dualize_ltv_device(jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
                           np.eye(3), np.eye(2), None, None, iterations=50)
    with pytest.raises(ValueError, match="both x_min and x_max"):
        dualize_ltv_device(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
            np.eye(3), np.eye(2), np.full(2, -1.0), np.full(2, 1.0),
            iterations=50, x_min=np.full(3, -1.0),
        )


# --- soft state boxes (slack-free dual damping) + general polytopes -----


def test_soft_state_matches_host_slack_formulation():
    """Device soft = dual damping (GPADData.soft_damp, no slack variables)
    must reach the SAME optimum as the host slack formulation
    (condense soft_state=rho appends 2 N n_x slacks)."""
    A, B, c = _ltv(seed=11)
    Q, R = np.eye(3), 0.5 * np.eye(2)
    rho = 50.0
    # tight box so the soft rows actually activate
    bounds = dict(
        x_min=np.full(3, -0.15), x_max=np.full(3, 0.15),
        u_min=np.full(2, -1.0), u_max=np.full(2, 1.0),
    )
    problem = LinearMPCProblem(A=A, B=B, Q=Q, R=R, horizon=6, c=c, **bounds)
    qp_h = tpu_gpad.condense(problem, tracking=True, soft_state=rho)
    host = tpu_gpad.dualize(qp_h, iterations=2000, paired="auto")
    assert not host.paired  # slack rows are one-sided on the host path
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c), Q, R,
        bounds["u_min"], bounds["u_max"], iterations=2000,
        x_min=bounds["x_min"], x_max=bounds["x_max"], soft_state=rho,
    )
    assert dev.soft_damp is not None
    # damp lives on the 18 state-box rows only; L gained +1/rho
    damp = np.asarray(dev.soft_damp)
    assert (damp[:18] > 0).all() and (damp[18:] == 0).all()
    p = np.concatenate(
        [[0.4, -0.3, 0.2], np.zeros(3)]
    ).astype(np.float32)[None]
    cfg = SolverConfig(iterations=2000, restart=True)
    r_h = solve_batch(host, p, config=cfg)
    r_d = solve_batch(dev, p, config=cfg)
    np.testing.assert_allclose(
        np.asarray(r_d.u), np.asarray(r_h.u), atol=1e-4
    )
    # non-vacuous: the soft rows are active (positive dual <=> slack used)
    y = np.asarray(r_d.y[0])
    assert y[:, :18].max() > 1e-3


def test_soft_state_eps_mode_converges():
    """The regularized eps test (violation measured against the recovered
    slack, gap against the damped gradient) terminates on soft data."""
    A, B, c = _ltv(seed=11)
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
        np.eye(3), 0.5 * np.eye(2),
        np.full(2, -1.0), np.full(2, 1.0), iterations=3000,
        x_min=np.full(3, -0.15), x_max=np.full(3, 0.15), soft_state=50.0,
    )
    p = np.concatenate(
        [[0.4, -0.3, 0.2], np.zeros(3)]
    ).astype(np.float32)[None]
    cfg = SolverConfig(mode="eps", eps_g=1e-5, eps_V=1e-5, iterations=3000,
                       restart=True)
    res = solve_batch(dev, p, config=cfg)
    assert np.asarray(res.converged).all()
    assert int(np.asarray(res.iterations)[0]) < 3000
    # the reported residual is the SOFT violation (vs recovered slack)
    assert float(np.asarray(res.residual)[0]) <= 1e-4


def _soft_dev_data(iterations=400):
    A, B, c = _ltv(seed=11)
    return dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
        np.eye(3), 0.5 * np.eye(2),
        np.full(2, -1.0), np.full(2, 1.0), iterations=iterations,
        x_min=np.full(3, -0.2), x_max=np.full(3, 0.2), soft_state=10.0,
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(form="dual"),  # fused dual kernel
        dict(form="dual", restart=True),  # + O'Donoghue-Candes recursion
        dict(form="mvp", flat="on"),  # flat (identity-block) XLA loop
        dict(form="mvp", flat="off"),  # dense paired XLA loop
        dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=37),
    ],
    ids=["dual", "dual-restart", "flat", "paired", "eps"],
)
def test_soft_pallas_kernels_match_xla(kw, interpret_kernel):
    """The fused dual kernel carries GPADData.soft_damp: forced pallas
    (interpret mode on CPU) must track the XLA loop's damped iteration.
    The forms it does not run route "auto" to that very XLA loop."""
    from tpu_gpad.solver import kernels
    from tpu_gpad.solver.core import resolve_engine

    dev = _soft_dev_data()
    rng = np.random.default_rng(5)
    p = np.concatenate(
        [rng.uniform(-0.5, 0.5, (6, 3)), np.zeros((6, 3))], axis=1
    ).astype(np.float32)
    r_x = solve_batch(
        dev, p, config=SolverConfig(iterations=300, engine="xla", **kw)
    )
    cfg = SolverConfig(iterations=300, **kw)
    engine = "pallas" if kernels.admits(dev, cfg)[0] else "auto"
    assert (engine == "pallas") == (kw.get("form") == "dual")
    cfg = dataclasses.replace(cfg, engine=engine)
    assert resolve_engine(dev, cfg) == ("pallas" if engine == "pallas" else "xla")
    r_p = solve_batch(dev, p, config=cfg)
    tol = 2e-5
    np.testing.assert_allclose(np.asarray(r_p.u), np.asarray(r_x.u), atol=tol)
    if kw.get("mode") == "eps":
        np.testing.assert_array_equal(
            np.asarray(r_p.iterations), np.asarray(r_x.iterations)
        )
        assert np.asarray(r_p.converged).all()
        assert np.asarray(r_p.residual).max() <= 1.1e-4
    else:
        np.testing.assert_allclose(
            np.asarray(r_p.y), np.asarray(r_x.y), atol=tol
        )
        np.testing.assert_allclose(
            np.asarray(r_p.residual), np.asarray(r_x.residual), atol=tol
        )
    # non-vacuous: the damped (soft) rows carry active duals
    assert np.asarray(r_p.y)[:, :, :18].max() > 1e-3


def test_soft_pallas_warm_start_matches_xla(interpret_kernel):
    dev = _soft_dev_data()
    p = np.concatenate([[0.45, -0.3, 0.2], np.zeros(3)]).astype(
        np.float32
    )[None]
    cold = solve_batch(
        dev, p, config=SolverConfig(iterations=200, engine="xla")
    )
    kw = dict(iterations=60, form="dual")
    r_x = solve_batch(
        dev, p, config=SolverConfig(engine="xla", **kw), y0=cold.y
    )
    r_p = solve_batch(
        dev, p, config=SolverConfig(engine="pallas", **kw), y0=cold.y
    )
    np.testing.assert_allclose(
        np.asarray(r_p.u), np.asarray(r_x.u), atol=2e-5
    )


def test_soft_routing_and_tiled_guards(monkeypatch):
    """auto takes the fused dual kernel for soft (paired) data exactly when
    the backend is a GPU; unpaired soft data has no kernel and forcing
    pallas there refuses loudly instead of dropping the damping."""
    from tpu_gpad.solver import kernels
    from tpu_gpad.solver.core import resolve_engine

    dev = _soft_dev_data(iterations=100)
    cfg = SolverConfig(iterations=100)
    assert resolve_engine(dev, cfg) == "xla"  # CPU backend
    monkeypatch.setattr(kernels, "on_gpu", lambda: True)
    assert resolve_engine(dev, cfg) == "pallas"
    undamped = dataclasses.replace(dev, paired=False)
    assert resolve_engine(undamped, cfg) == "xla"
    with pytest.raises(ValueError, match="paired"):
        resolve_engine(undamped, dataclasses.replace(cfg, engine="pallas"))


def test_polytopes_match_host_dense_path():
    """One-sided H_x/H_u rows: paired-with-inert-minus-side on device vs
    the host's dense (unpaired) fallback layout."""
    A, B, c = _ltv(seed=13)
    Q, R = np.eye(3), 0.5 * np.eye(2)
    H_x = np.array([[1.0, 1.0, 0.0]])
    h_x = np.array([0.08])  # tight: actually active at this x0
    H_u = np.array([[1.0, -1.0]])
    h_u = np.array([0.6])
    bounds = dict(
        x_min=np.full(3, -2.0), x_max=np.full(3, 2.0),
        u_min=np.full(2, -1.0), u_max=np.full(2, 1.0),
    )
    problem = LinearMPCProblem(
        A=A, B=B, Q=Q, R=R, horizon=6, c=c,
        H_x=H_x, h_x=h_x, H_u=H_u, h_u=h_u, **bounds
    )
    qp_h = tpu_gpad.condense(problem, tracking=True)
    host = tpu_gpad.dualize(qp_h, iterations=2000, paired="auto")
    assert not host.paired  # one-sided rows defeat pairing on host
    dev = dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c), Q, R,
        bounds["u_min"], bounds["u_max"], iterations=2000,
        x_min=bounds["x_min"], x_max=bounds["x_max"],
        H_x=H_x, h_x=h_x, H_u=H_u, h_u=h_u,
    )
    # flat contract intact: polytope rows are structure, identity last
    assert dev.paired and dev.n_struct == 18 + 6 + 6
    p = np.concatenate(
        [[0.4, -0.3, 0.2], np.zeros(3)]
    ).astype(np.float32)[None]
    cfg = SolverConfig(iterations=2000, restart=True)
    r_h = solve_batch(host, p, config=cfg)
    r_d = solve_batch(dev, p, config=cfg)
    np.testing.assert_allclose(
        np.asarray(r_d.u), np.asarray(r_h.u), atol=1e-4
    )
    y = np.asarray(r_d.y[0])
    # non-vacuous: at least one polytope row is active...
    assert y[0, 18:30].max() > 1e-3
    # ...and every inert minus side stayed exactly 0
    assert np.abs(y[1, 18:30]).max() == 0.0


def test_nmpc_device_soft_and_polytopes_match_host():
    from tpu_gpad.nonlinear import NMPC, rk4, simulate_nonlinear
    from tpu_gpad.problems.pendulum import UPRIGHT, pendulum_dynamics

    f = rk4(pendulum_dynamics(), dt=0.05)
    x0 = np.array([2.4, 0.0], np.float32)
    for extra in (
        dict(x_min=np.array([-6.0, -5.5]), x_max=np.array([6.0, 5.5]),
             soft_state=30.0),
        dict(x_min=np.array([-6.0, -5.5]), x_max=np.array([6.0, 5.5]),
             H_x=np.array([[1.0, 0.4]]), h_x=np.array([4.0]),
             H_u=np.array([[1.0]]), h_u=np.array([10.0])),
    ):
        kw = dict(n_x=2, n_u=1, horizon=8, Q=np.diag([10.0, 1.0]),
                  R=np.diag([0.1]), u_min=np.array([-11.0]),
                  u_max=np.array([11.0]), iterations=120, sqp_iters=1,
                  **extra)
        X_h, _ = simulate_nonlinear(
            f, NMPC(f, **kw), x0, n_steps=12, x_ref=UPRIGHT)
        X_d, _ = simulate_nonlinear(
            f, NMPC(f, device_condense=True, **kw), x0, n_steps=12,
            x_ref=UPRIGHT)
        np.testing.assert_allclose(X_d, X_h, atol=5e-3)


def test_scenario_device_soft_matches_host():
    """Weighted scenario stack: scenario s's effective penalty is
    w_s * rho (scenario_qp scales H_s by w_s) — the device damping must
    match that, not the raw rho."""
    from tpu_gpad.device_condense import dualize_scenario_device
    from tpu_gpad.robust import scenario_qp

    rng = np.random.default_rng(3)
    S, N, n_x, n_u = 3, 6, 2, 1
    As = np.stack([
        np.stack([np.eye(n_x) + 0.1 * rng.standard_normal((n_x, n_x))
                  for _ in range(N)]) for _ in range(S)
    ])
    Bs = 0.5 * rng.standard_normal((S, N, n_x, n_u))
    cs = 0.03 * rng.standard_normal((S, N, n_x))
    Q, R = np.eye(n_x), 0.2 * np.eye(n_u)
    x_min, x_max = np.full(n_x, -0.2), np.full(n_x, 0.2)
    u_min, u_max = np.full(n_u, -1.5), np.full(n_u, 1.5)
    rho, weights = 40.0, (0.25, 0.5, 0.25)
    qps = [
        tpu_gpad.condense(
            LinearMPCProblem(A=As[s], B=Bs[s], Q=Q, R=R, horizon=N,
                             x_min=x_min, x_max=x_max, u_min=u_min,
                             u_max=u_max, c=cs[s]),
            tracking=True, soft_state=rho,
        )
        for s in range(S)
    ]
    host = tpu_gpad.dualize(
        scenario_qp(qps, weights=weights), iterations=2000, paired="auto"
    )
    dev = dualize_scenario_device(
        jnp.asarray(As, jnp.float32), jnp.asarray(Bs, jnp.float32),
        jnp.asarray(cs, jnp.float32), Q, R, u_min, u_max,
        iterations=2000, weights=weights, x_min=x_min, x_max=x_max,
        soft_state=rho,
    )
    # per-scenario damping scales with 1/w_s
    damp = np.asarray(dev.soft_damp)
    blk = N * n_x
    np.testing.assert_allclose(
        damp[:blk] * 0.25, damp[blk:2 * blk] * 0.5, rtol=1e-5
    )
    p = np.concatenate([[0.5, -0.4], np.zeros(n_x)]).astype(np.float32)[None]
    cfg = SolverConfig(iterations=2000, restart=True)
    r_h = solve_batch(host, p, config=cfg)
    r_d = solve_batch(dev, p, config=cfg)
    np.testing.assert_allclose(
        np.asarray(r_d.u), np.asarray(r_h.u), atol=1e-4
    )
    assert np.asarray(r_d.y[0])[:, :S * blk].max() > 1e-3  # soft active


def test_robust_nmpc_device_soft_closed_loop():
    from tpu_gpad.nonlinear import RobustNMPC, rk4

    def pend(g):
        def f_cont(x, u):
            th, om = x
            return jnp.array([om, g * jnp.sin(th) - 0.1 * om + u[0]])

        return rk4(f_cont, 0.05)

    gs = (8.8, 9.81, 10.8)
    kw = dict(
        n_x=2, n_u=1, horizon=6, Q=np.diag([10.0, 1.0]), R=0.1 * np.eye(1),
        x_min=np.array([-6.0, -4.0]), x_max=np.array([6.0, 4.0]),
        u_min=np.array([-11.0]), u_max=np.array([11.0]),
        soft_state=25.0, iterations=300, sqp_iters=1,
    )
    ref = np.array([np.pi, 0.0], np.float32)
    x0 = np.array([2.3, 0.0], np.float32)
    plant = pend(10.8)
    trajs = {}
    for label, dev in (("host", False), ("device", True)):
        ctrl = RobustNMPC([pend(g) for g in gs], device_condense=dev, **kw)
        x = jnp.asarray(x0)
        X = [np.asarray(x)]
        for _ in range(10):
            u = ctrl.step(np.asarray(x), ref)
            x = plant(x, jnp.asarray(u, dtype=jnp.float32))
            X.append(np.asarray(x))
        trajs[label] = np.stack(X)
    np.testing.assert_allclose(
        trajs["device"], trajs["host"], atol=5e-3
    )


def test_soft_damp_survives_stack_and_padding():
    """GPADData transformers must carry soft_damp: stack_data (multi-plant)
    and pad_dual_rows (TP padding, damp 0 on padded rows)."""
    from tpu_gpad.parallel.distrib import pad_dual_rows
    from tpu_gpad.solver.multi import stack_data

    A, B, c = _ltv(seed=11)
    mk = lambda seed: dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
        np.eye(3), 0.5 * np.eye(2),
        np.full(2, -1.0), np.full(2, 1.0), iterations=50,
        x_min=np.full(3, -0.2), x_max=np.full(3, 0.2), soft_state=10.0,
    )
    d = mk(0)
    stacked = stack_data([d, d])
    assert stacked.soft_damp.shape == (2, d.m_half)
    padded = pad_dual_rows(d, 3)
    assert padded.soft_damp.shape == (d.m_half + 3,)
    assert (np.asarray(padded.soft_damp)[-3:] == 0).all()


def test_bad_weight_shapes_raise():
    """Traced-weight support must not relax the Q/R shape validation:
    a diag VECTOR (the natural mistake next to jnp.diag examples),
    a scalar, or a (1, n) row must all raise, not broadcast silently."""
    A, B, c = _ltv(seed=0)
    kw = dict(u_min=np.full(2, -1.0), u_max=np.full(2, 1.0), iterations=50)
    for bad_q in (np.array([1.0, 2.0, 3.0]), 2.0, np.ones((1, 3))):
        with pytest.raises(ValueError, match="Q must be"):
            dualize_ltv_device(
                jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
                bad_q, 0.5 * np.eye(2), **kw,
            )
    with pytest.raises(ValueError, match="R must be"):
        dualize_ltv_device(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
            np.eye(3), np.array([0.5, 0.5]), **kw,
        )

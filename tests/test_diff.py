"""Implicit differentiation (tpu_gpad.diff) vs finite differences.

Ground truth is the float64 active-set QP (`solver.qp.solve_qp_exact`)
differentiated by central differences — the solver-independent oracle.
The module under test computes the same derivative from the masked KKT
system at a converged GPAD solve.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tpu_gpad
from tpu_gpad import diff, problems
from tpu_gpad.problems.battery import default_x0
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.qp import solve_condensed_qp


def _exact_u(qp, p, n_keep=None):
    sol = solve_condensed_qp(qp, np.asarray(p, np.float64))
    assert sol.status == "optimal", sol.status
    return sol.z[: (n_keep or qp.n_u)]


def _fd_gain(qp, p, h=1e-5, n_keep=None):
    p = np.asarray(p, np.float64)
    cols = []
    for j in range(p.size):
        e = np.zeros_like(p)
        e[j] = h
        cols.append(
            (_exact_u(qp, p + e, n_keep) - _exact_u(qp, p - e, n_keep))
            / (2 * h)
        )
    return np.stack(cols, axis=1)  # (n_u, n_p)


def _converged(data, P, **kw):
    cfg = SolverConfig(iterations=300, restart=True, engine="xla", **kw)
    return solve_batch(data, jnp.asarray(P, jnp.float32), config=cfg)


def test_gain_unconstrained_is_analytic():
    """Interior x0: no active rows -> K_u == -(H^-1 F')[:n_u] exactly."""
    qp = tpu_gpad.condense(problems.double_integrator(horizon=8))
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    x0 = np.array([0.01, -0.005], np.float32)
    res = _converged(data, x0[None])
    assert float(np.asarray(res.y).max()) < 1e-7  # truly interior
    K_u, K_z = diff.sensitivity(data, res.y)
    expected = -np.asarray(data.gP_map).T[: data.n_u]
    np.testing.assert_allclose(np.asarray(K_u[0]), expected[:, : x0.size],
                               atol=1e-6)
    assert K_z.shape == (1, data.n_z, x0.size)


@pytest.mark.parametrize("seed", [0, 3])
def test_gain_matches_fd_paired_battery(seed):
    """Battery (boxes + equality coupling pairs): K_u vs f64 FD oracle."""
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=8))
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    assert data.paired
    from tpu_gpad.problems.battery import default_x0

    x0 = default_x0(3, seed=seed).astype(np.float32)
    res = _converged(data, x0[None])
    # strict active set required for differentiability: verified by the
    # oracle's multipliers being clearly signed
    K = np.asarray(diff.feedback_gain(data, res)[0])
    K_fd = _fd_gain(qp, x0)
    np.testing.assert_allclose(K, K_fd, atol=2e-3)
    # the coupling rows are active (equality): both sides' duals may be
    # positive simultaneously — the case active_signs must not cancel
    assert np.asarray(res.y).max() > 1e-4


def test_gain_matches_fd_dense_polytope():
    """One-sided H_x rows force the dense (unpaired) dual layout."""
    base = problems.double_integrator(horizon=8)
    import dataclasses

    prob = dataclasses.replace(
        base,
        H_x=np.array([[1.0, 0.6]]),
        h_x=np.array([2.0]),
    )
    qp = tpu_gpad.condense(prob)
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    assert not data.paired
    x0 = np.array([1.5, 0.8], np.float32)  # polytope row active
    res = _converged(data, x0[None])
    assert np.asarray(res.y).max() > 1e-4
    K = np.asarray(diff.feedback_gain(data, res)[0])
    K_fd = _fd_gain(qp, x0)
    np.testing.assert_allclose(K, K_fd, atol=2e-3)


def test_gain_matches_fd_tracking_param():
    """Extended parameter p = [x0; r]: sensitivity to the reference too."""
    qp = tpu_gpad.condense(
        problems.double_integrator(horizon=8), tracking=True
    )
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    p = np.array([0.4, 0.2, -0.3, 0.0], np.float32)  # [x0; r]
    res = _converged(data, p[None])
    K = np.asarray(diff.feedback_gain(data, res)[0])
    K_fd = _fd_gain(qp, p)
    np.testing.assert_allclose(K, K_fd, atol=2e-3)


def test_soft_sensitivity_matches_slack_qp_fd():
    """Device soft rows (dual damping) vs the host slack formulation's
    exact-QP derivative: same optimum -> same du*/dx0."""
    from tpu_gpad.device_condense import dualize_ltv_device

    rng = np.random.default_rng(2)
    n, nu, N = 3, 2, 8
    A = np.stack([np.eye(n) + 0.03 * rng.standard_normal((n, n))
                  for _ in range(N)])
    B = np.stack([0.2 * rng.standard_normal((n, nu)) for _ in range(N)])
    c = np.zeros((N, n))
    rho = 8.0
    kw = dict(x_min=np.full(n, -0.25), x_max=np.full(n, 0.25))
    dev = dualize_ltv_device(
        jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32),
        jnp.asarray(c, jnp.float32), np.eye(n), 0.5 * np.eye(nu),
        np.full(nu, -1.0), np.full(nu, 1.0), iterations=400,
        soft_state=rho, **kw,
    )
    assert dev.soft_damp is not None
    # host oracle: same LTV plant, slack-variable soft formulation
    prob = tpu_gpad.types.LinearMPCProblem(
        A=A, B=B, Q=np.eye(n), R=0.5 * np.eye(nu), horizon=N,
        u_min=np.full(nu, -1.0), u_max=np.full(nu, 1.0), **kw,
    )
    qp_host = tpu_gpad.condense(prob, soft_state=rho, tracking=True)
    x0 = np.array([0.4, -0.3, 0.2], np.float32)
    p = np.concatenate([x0, np.zeros(n)]).astype(np.float32)
    res = _converged(dev, p[None])
    # soft rows carry active duals (the trajectory leans on the soft box)
    soft_rows = np.asarray(dev.soft_damp) > 0
    assert np.asarray(res.y)[0][:, soft_rows].max() > 1e-3
    K = np.asarray(diff.feedback_gain(dev, res)[0])
    K_fd = _fd_gain(qp_host, p)
    np.testing.assert_allclose(K, K_fd, atol=3e-3)


def test_vjp_matches_sensitivity_and_fd():
    """grad through make_differentiable_solver == K' @ u_bar, and both
    match the oracle-FD directional derivative."""
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=8))
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    cfg = SolverConfig(iterations=300, restart=True, engine="xla")
    from tpu_gpad.problems.battery import default_x0

    f = diff.make_differentiable_solver(data, cfg)
    P = np.stack([default_x0(3, seed=s) for s in (1, 2, 3)]).astype(
        np.float32
    )
    Pj = jnp.asarray(P)

    def loss(p):
        return 0.5 * jnp.sum(f(p) ** 2)

    g = jax.grad(loss)(Pj)
    res = solve_batch(data, Pj, config=cfg)
    K_u, _ = diff.sensitivity(data, res.y)
    g_manual = jnp.einsum("bup,bu->bp", K_u, res.u)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_manual),
                               rtol=1e-5, atol=5e-7)
    # FD of the f64 oracle loss for scenario 0
    h = 1e-5
    g_fd = np.zeros(qp.n_x)
    for j in range(qp.n_x):
        e = np.zeros(qp.n_x)
        e[j] = h
        lp = 0.5 * np.sum(_exact_u(qp, P[0] + e) ** 2)
        lm = 0.5 * np.sum(_exact_u(qp, P[0] - e) ** 2)
        g_fd[j] = (lp - lm) / (2 * h)
    np.testing.assert_allclose(np.asarray(g)[0], g_fd, atol=2e-3)


def test_vjp_full_trajectory_and_jit():
    qp = tpu_gpad.condense(problems.double_integrator(horizon=6))
    data = tpu_gpad.dualize(qp, iterations=300, paired="auto")
    cfg = SolverConfig(iterations=200, restart=True, engine="xla")
    f = diff.make_differentiable_solver(data, cfg, full_trajectory=True)

    @jax.jit
    def loss(p):
        return jnp.sum(jnp.abs(f(p)))

    p = jnp.asarray(np.array([[0.5, -0.2]], np.float32))
    g = jax.grad(loss)(p)
    assert g.shape == p.shape and bool(jnp.isfinite(g).all())
    # FD against the oracle's full trajectory
    h = 1e-5
    g_fd = np.zeros(2)
    for j in range(2):
        e = np.zeros(2)
        e[j] = h
        lp = np.abs(_exact_u(qp, np.asarray(p[0]) + e, n_keep=qp.n_z)).sum()
        lm = np.abs(_exact_u(qp, np.asarray(p[0]) - e, n_keep=qp.n_z)).sum()
        g_fd[j] = (lp - lm) / (2 * h)
    np.testing.assert_allclose(np.asarray(g)[0], g_fd, atol=2e-3)


def test_controller_gain_convenience():
    """Controller.gain() returns the explicit-MPC gain at the last step
    and matches the unconstrained analytic gain in the interior."""
    from tpu_gpad.closed_loop import Controller

    prob = problems.double_integrator(horizon=6)
    ctrl = Controller(prob, iterations=200,
                      config=SolverConfig(iterations=200, restart=True))
    with pytest.raises(ValueError, match="step"):
        ctrl.gain()
    ctrl.step(np.array([0.01, 0.0], np.float32))
    K = ctrl.gain()
    assert K.shape == (1, 2)
    expected = -np.asarray(ctrl.data.gP_map).T[:1]
    np.testing.assert_allclose(K, expected, atol=1e-6)


def test_cg_solver_matches_cholesky():
    """method='cg' == method='chol' (the default) on every layout."""
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=8))
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    from tpu_gpad.problems.battery import default_x0

    P = np.stack([default_x0(3, seed=s) for s in (0, 3)]).astype(np.float32)
    res = _converged(data, P)
    K_chol, _ = diff.sensitivity(data, res.y, method="chol")
    K_cg, _ = diff.sensitivity(data, res.y, method="cg")
    np.testing.assert_allclose(np.asarray(K_cg), np.asarray(K_chol),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="method"):
        diff.sensitivity(data, res.y, method="qr")
    # grads too, incl. the data path
    cfg = SolverConfig(iterations=300, restart=True, engine="xla")
    f_cg = diff.make_data_differentiable_solver(cfg, method="cg")
    f_ch = diff.make_data_differentiable_solver(cfg, method="chol")
    Pj = jnp.asarray(P)
    g_cg = jax.grad(lambda p: 0.5 * jnp.sum(f_cg(data, p) ** 2))(Pj)
    g_ch = jax.grad(lambda p: 0.5 * jnp.sum(f_ch(data, p) ** 2))(Pj)
    # atol 1e-5: CG's exit is a 1e-5 relative-residual reduction by
    # design (the fp32-safe bound — tighter exits stagnate-then-diverge,
    # see _sw_masked_cg), so near-zero gradient components resolve to
    # ~1e-5, not machine epsilon
    np.testing.assert_allclose(np.asarray(g_cg), np.asarray(g_ch),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "make, P",
    [
        (lambda: problems.battery(n_cells=3, horizon=8),
         lambda: np.stack([default_x0(3, seed=s) for s in range(4)])),
        (lambda: problems.battery(n_cells=3, horizon=10),
         lambda: np.random.default_rng(0).uniform(-0.5, 0.5, (4, 3))),
    ],
    ids=["battery_n3N8", "battery_n3N10"],
)
def test_cg_matches_cholesky_batched_and_alone(make, P):
    """CG against the default (Cholesky) KKT solve, in a batch and one
    scenario at a time. CG stops each scenario at a 1e-5 relative
    residual, so it agrees with Cholesky to 2e-5 of the largest entry here
    (measured on the CPU: 5e-6 of max|K|, 7e-6 of max|grad|; at battery
    n3 N50 its gradient error reaches 1.9e-4 of max|grad|, PERF.md); a
    scenario's result does not depend on its batch beyond the forward
    solve's own rounding (Cholesky: 1.6e-7)."""
    qp = tpu_gpad.condense(make())
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    cfg = SolverConfig(iterations=300, restart=True, engine="xla")
    P = jnp.asarray(P(), jnp.float32)
    res = solve_batch(data, P, config=cfg)
    K_chol, _ = diff.sensitivity(data, res.y)
    K_cg, _ = diff.sensitivity(data, res.y, method="cg")
    K_alone = jnp.stack([diff.sensitivity(data, res.y[i], method="cg")[0]
                         for i in range(P.shape[0])])
    scale = float(jnp.abs(K_chol).max())
    np.testing.assert_allclose(np.asarray(K_cg), np.asarray(K_chol),
                               atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(K_alone), np.asarray(K_cg),
                               atol=1e-6)

    def grads(method):
        f = diff.make_differentiable_solver(data, cfg, method=method)
        g = jax.grad(lambda p: 0.5 * jnp.sum(f(p) ** 2))
        return g(P), jnp.concatenate([g(P[i:i + 1]) for i in range(P.shape[0])])

    g_chol, _ = grads("auto")
    g_cg, g_cg_alone = grads("cg")
    scale = float(jnp.abs(g_chol).max())
    np.testing.assert_allclose(np.asarray(g_cg), np.asarray(g_chol),
                               atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(g_cg_alone), np.asarray(g_cg),
                               atol=5e-7)

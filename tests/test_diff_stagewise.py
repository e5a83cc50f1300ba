"""Implicit differentiation through the STAGE-WISE engine (diff.py's
matrix-free KKT adjoint) vs the condensed path and finite differences.

Two oracles: (1) at condensable shapes, the float64 active-set QP
differentiated by central differences (solver-independent ground truth,
same as test_diff.py) and the condensed `sensitivity` — the stage-wise
gradient must agree with both; (2) at condensation-hostile shapes
(battery n30 N200: ~586 MB condensed operands), directional finite
differences of the stage-wise solve itself."""

import numpy as np
import jax
import jax.numpy as jnp


import tpu_gpad
from tpu_gpad import diff, problems
from tpu_gpad.solver import SolverConfig
from tpu_gpad.solver.qp import solve_condensed_qp
from tpu_gpad.stagewise import build_stagewise
from tpu_gpad.condense import condense, lipschitz_constant


def _exact_u(qp, p):
    sol = solve_condensed_qp(qp, np.asarray(p, np.float64))
    assert sol.status == "optimal", sol.status
    return sol.z[: qp.n_u]


def _fd_gain(qp, p, h=1e-5):
    p = np.asarray(p, np.float64)
    cols = []
    for j in range(p.size):
        e = np.zeros_like(p)
        e[j] = h
        cols.append((_exact_u(qp, p + e) - _exact_u(qp, p - e)) / (2 * h))
    return np.stack(cols, axis=1)


_CFG = SolverConfig(iterations=400, restart=True)


def test_sw_gain_matches_exact_qp_fd():
    """Active boxes + coupling rows: du*/dx0 from the stage-wise adjoint
    == central differences of the f64 active-set QP."""
    prob = problems.battery(3, 8)
    qp = condense(prob)
    data = build_stagewise(prob, iterations=400,
                           L=lipschitz_constant(qp))
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-0.35, 0.35, size=3).astype(np.float32)
    K = diff.stagewise_feedback_gain(data, x0, config=_CFG)
    K_fd = _fd_gain(qp, x0)
    np.testing.assert_allclose(np.asarray(K), K_fd,
                               atol=2e-3)


def test_sw_gain_matches_condensed_sensitivity():
    """Same problem, both engines, both adjoints: the stage-wise gain
    equals the condensed `sensitivity` gain (identical QP, identical
    active set)."""
    prob = problems.battery(3, 10)
    qp = condense(prob)
    L = lipschitz_constant(qp)
    data_c = tpu_gpad.dualize(qp, iterations=400, paired="auto", L=L)
    data_s = build_stagewise(prob, iterations=400, L=L)
    rng = np.random.default_rng(7)
    X0 = rng.uniform(-0.3, 0.3, size=(3, 3)).astype(np.float32)
    res_c = tpu_gpad.solve_batch(data_c, jnp.asarray(X0), config=_CFG)
    K_c, _ = diff.sensitivity(data_c, res_c.y)
    K_s = diff.stagewise_feedback_gain(data_s, X0, config=_CFG)
    np.testing.assert_allclose(np.asarray(K_s), np.asarray(K_c),
                               atol=5e-4)


def test_sw_vjp_condensation_infeasible_shape_fd():
    """The VERDICT r04 item-2 check: FD-verified gradients where
    condensing cannot go — battery n30 N200 (~586 MB condensed operands;
    the stage-wise data is ~2 MB). Directional central differences of the
    stage-wise solve itself (h large enough to clear the fp32 fixed-point
    plateau)."""
    prob = problems.battery(30, 200)
    # 600 restart iterations: converged (resid ~2e-5) at this shape —
    # gradients differentiate the FIXED POINT, so an unconverged forward
    # (120 iters: resid 0.045) gives FD mismatch by construction
    data = build_stagewise(prob, iterations=600)
    cfg = SolverConfig(iterations=600, restart=True)
    f = diff.make_differentiable_stagewise_solver(data, config=cfg)
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-0.04, 0.04, size=30).astype(np.float32)
    loss = lambda x: jnp.sum(f(x[None]) ** 2)
    g = np.asarray(jax.grad(loss)(jnp.asarray(x0)))
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0

    # u*(x0) is piecewise affine with THOUSANDS of facets at this shape
    # (m = 24400 dual rows); the implicit gradient is the active
    # region's one-sided derivative, so FD is only a valid oracle along
    # directions where the loss is locally LINEAR. Gate on FD
    # h-consistency (Richardson spread across 3 step sizes) and validate
    # on the qualifying directions (probed: spread <= 10% directions
    # match the adjoint to 1-4%; kink-crossing ones scatter by design).
    def fd_dir(v, h):
        lp = float(loss(jnp.asarray(x0 + h * v, jnp.float32)))
        lm = float(loss(jnp.asarray(x0 - h * v, jnp.float32)))
        return (lp - lm) / (2 * h)

    checked = 0
    for seed in range(8):
        v = np.random.default_rng(seed).normal(size=30)
        v /= np.linalg.norm(v)
        fds = [fd_dir(v, h) for h in (0.01, 0.02, 0.04)]
        mid = float(np.median(fds))
        if max(fds) - min(fds) > 0.1 * max(0.5, abs(mid)):
            continue  # stencil crosses an active-set facet
        got = float(g @ v)
        assert abs(got - mid) <= 0.1 * max(0.5, abs(mid)), (seed, got, fds)
        checked += 1
        if checked == 2:
            break
    assert checked >= 1, "no locally-linear FD direction found"


def test_sw_vjp_full_trajectory_and_jit():
    """full_trajectory VJP under jit, checked against the condensed
    full-trajectory VJP on the twin problem."""
    prob = problems.battery(3, 8)
    qp = condense(prob)
    L = lipschitz_constant(qp)
    data_c = tpu_gpad.dualize(qp, iterations=400, paired="auto", L=L)
    data_s = build_stagewise(prob, iterations=400, L=L)
    f_s = diff.make_differentiable_stagewise_solver(
        data_s, config=_CFG, full_trajectory=True)
    f_c = diff.make_differentiable_solver(
        data_c, config=_CFG, full_trajectory=True)
    rng = np.random.default_rng(9)
    X0 = jnp.asarray(
        rng.uniform(-0.3, 0.3, size=(2, 3)).astype(np.float32))
    w = jnp.asarray(
        rng.normal(size=(qp.n_z,)).astype(np.float32))
    loss_s = jax.jit(lambda x: jnp.sum(f_s(x) @ w))
    loss_c = jax.jit(lambda x: jnp.sum(f_c(x) @ w))
    np.testing.assert_allclose(
        float(loss_s(X0)), float(loss_c(X0)),
        rtol=1e-4)
    g_s = jax.grad(lambda x: loss_s(x))(X0)
    g_c = jax.grad(lambda x: loss_c(x))(X0)
    np.testing.assert_allclose(
        np.asarray(g_s), np.asarray(g_c), atol=5e-4)


def test_sw_interior_gain_is_lqr():
    """Interior x0 (no active rows — boxes only, so unlike the battery's
    always-active coupling equalities they truly release): the stage-wise
    gain reduces to the unconstrained LQR feedback -(H^-1 F')[:n_u]."""
    prob = problems.double_integrator(horizon=8)
    qp = condense(prob)
    data = build_stagewise(prob, iterations=300,
                           L=lipschitz_constant(qp))
    x0 = np.array([0.01, -0.005], np.float32)
    K = diff.stagewise_feedback_gain(data, x0, config=_CFG)
    Hinv_Ft = np.linalg.solve(qp.H, qp.F.T)
    K_ref = -Hinv_Ft[: qp.n_u]
    np.testing.assert_allclose(np.asarray(K), K_ref,
                               atol=1e-4)

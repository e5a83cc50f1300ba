"""Data-side gradients (diff.make_data_differentiable_solver) vs finite
differences of the solver itself.

Leaf-wise FD perturbs stored operands independently, which only keeps the
fixed point consistent in the mvp form (the dual form reads D, which a
lone MG_T perturbation would desynchronize) — so the FD oracle forces
form="mvp". The end-to-end test then checks the consistent-manifold
story: jax.grad through dualize_ltv_device reaching the cost weights.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tpu_gpad
from tpu_gpad import diff, problems
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.problems.battery import default_x0

CFG = SolverConfig(iterations=300, restart=True, engine="xla", form="mvp")

# Finite-difference step and tolerances of the data-grad checks;
# grad-path-vs-grad-path comparisons only need the fp32 KKT-solve slack.
_H = 3e-5
_FD_ABS = 2e-3
_FD_REL = 5e-3
_GG_ATOL = 1e-7


def _loss_fn(f, P):
    def loss(data, p):
        return 0.5 * jnp.sum(f(data, p) ** 2)

    return loss


def _fd_leaf(data, P, leaf, idx, h=_H):
    """Central difference of the loss w.r.t. one coordinate of one leaf."""

    def loss_at(d):
        u = solve_batch(d, P, config=CFG).u
        return 0.5 * float(jnp.sum(u**2))

    arr = getattr(data, leaf)
    for sgn in (+1, -1):
        pert = jnp.asarray(arr).at[idx].add(sgn * h)
        yield loss_at(dataclasses.replace(data, **{leaf: pert}))


def _check_leaves(data, P, coords, atol=None, rtol=None):
    atol = _FD_ABS if atol is None else atol
    rtol = _FD_REL if rtol is None else rtol
    f = diff.make_data_differentiable_solver(CFG)
    loss = _loss_fn(f, P)
    gd, gp = jax.grad(loss, argnums=(0, 1))(data, P)
    for leaf, idx in coords:
        lp, lm = _fd_leaf(data, P, leaf, idx)
        fd = (lp - lm) / (2 * _H)
        got = float(getattr(gd, leaf)[idx])
        assert got == pytest.approx(fd, abs=atol, rel=rtol), (leaf, idx,
                                                              got, fd)
    return gd, gp


def test_leaf_cotangents_match_fd_paired():
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=8))
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    P = jnp.asarray(
        np.stack([default_x0(3, seed=s) for s in (1, 2)]), jnp.float32
    )
    coords = [
        ("MG_T", (4, 7)),
        ("MG_T", (0, 0)),
        ("GL_T", (5, 9)),
        ("GL_T", (2, 30)),
        ("gP_map", (1, 3)),
        ("gP_const", (2,)),
        ("pD_map", (0, 0, 11)),
        ("pD_map", (2, 1, 40)),
        ("pD_const", (0, 11)),
        ("pD_const", (1, 40)),
    ]
    _check_leaves(data, P, coords)


def test_leaf_cotangents_match_fd_dense():
    base = problems.double_integrator(horizon=8)
    prob = dataclasses.replace(
        base, H_x=np.array([[1.0, 0.6]]), h_x=np.array([2.0])
    )
    qp = tpu_gpad.condense(prob)
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    assert not data.paired
    P = jnp.asarray(np.array([[1.5, 0.8]]), jnp.float32)
    coords = [
        ("MG_T", (3, 2)),
        ("GL_T", (4, 19)),
        ("gP_map", (0, 1)),
        ("gP_const", (5,)),
        ("pD_map", (1, 8)),
        ("pD_const", (8,)),
    ]
    _check_leaves(data, P, coords)


def test_soft_damp_cotangent_matches_fd():
    from tpu_gpad.device_condense import dualize_ltv_device

    rng = np.random.default_rng(2)
    n, nu, N = 3, 2, 8
    A = np.stack([np.eye(n) + 0.03 * rng.standard_normal((n, n))
                  for _ in range(N)])
    B = np.stack([0.2 * rng.standard_normal((n, nu)) for _ in range(N)])
    data = dualize_ltv_device(
        jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32),
        jnp.zeros((N, n), jnp.float32), np.eye(n), 0.5 * np.eye(nu),
        np.full(nu, -1.0), np.full(nu, 1.0), iterations=400,
        x_min=np.full(n, -0.25), x_max=np.full(n, 0.25), soft_state=8.0,
    )
    P = jnp.asarray(
        np.concatenate([[0.4, -0.3, 0.2], np.zeros(3)], axis=0),
        jnp.float32,
    )[None]
    # a soft row with an active dual (nonzero cotangent expected)
    res = solve_batch(data, P, config=CFG)
    soft_rows = np.flatnonzero(np.asarray(data.soft_damp) > 0)
    y = np.asarray(res.y)[0]
    active_soft = soft_rows[
        (y[0, soft_rows] > 1e-4) | (y[1, soft_rows] > 1e-4)
    ]
    assert active_soft.size > 0
    coords = [("soft_damp", (int(active_soft[0]),)), ("MG_T", (2, 3))]
    gd, _ = _check_leaves(data, P, coords, atol=5e-3, rtol=2e-2)
    assert float(jnp.abs(gd.soft_damp).max()) > 0.0


def test_p_grad_matches_p_only_path():
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=8))
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    P = jnp.asarray(
        np.stack([default_x0(3, seed=s) for s in (1, 4)]), jnp.float32
    )
    f2 = diff.make_data_differentiable_solver(CFG)
    f1 = diff.make_differentiable_solver(data, CFG)
    g2 = jax.grad(lambda p: 0.5 * jnp.sum(f2(data, p) ** 2))(P)
    g1 = jax.grad(lambda p: 0.5 * jnp.sum(f1(p) ** 2))(P)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-5,
                               atol=_GG_ATOL)


def test_end_to_end_weight_learning_gradient():
    """The flagship composition: jax.grad through dualize_ltv_device +
    solve reaches the stage-cost weights (inverse optimal control)."""
    from tpu_gpad.device_condense import dualize_ltv_device

    rng = np.random.default_rng(5)
    n, nu, N = 2, 1, 6
    A = np.stack([np.array([[1.0, 0.1], [0.0, 0.95]])] * N)
    B = np.stack([np.array([[0.005], [0.1]])] * N)
    # device-condensed parameter is [x0; r] (tracking): zero reference
    P = jnp.asarray(
        np.array([[1.2, -0.4, 0.0, 0.0], [0.6, 0.3, 0.0, 0.0]]),
        jnp.float32,
    )
    f = diff.make_data_differentiable_solver(
        SolverConfig(iterations=250, restart=True, engine="xla",
                     form="mvp")
    )

    def u_of_q(q_diag):
        data = dualize_ltv_device(
            jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32),
            jnp.zeros((N, n), jnp.float32),
            jnp.diag(q_diag), 0.4 * np.eye(nu),
            np.full(nu, -0.5), np.full(nu, 0.5), iterations=300,
        )
        return f(data, P)

    def loss(q_diag):
        return 0.5 * jnp.sum(u_of_q(q_diag) ** 2)

    q0 = jnp.asarray([1.0, 0.6], jnp.float32)
    g = jax.grad(loss)(q0)
    assert np.isfinite(np.asarray(g)).all()
    h = 1e-3
    for j in range(2):
        e = jnp.zeros(2).at[j].set(h)
        fd = (float(loss(q0 + e)) - float(loss(q0 - e))) / (2 * h)
        assert float(g[j]) == pytest.approx(fd, abs=_FD_ABS, rel=max(_FD_REL, 2e-2)), (
            j, float(g[j]), fd
        )
    # the gradient is non-trivial (the weights really steer u*)
    assert float(jnp.abs(g).max()) > 1e-3


def test_unbatched_and_multibatch_p_grads():
    """The data-path bwd must accept any leading batch shape, like the
    forward (solve_batch takes (..., n_p))."""
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=8))
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    f = diff.make_data_differentiable_solver(CFG)
    p1 = jnp.asarray(default_x0(3, seed=1), jnp.float32)  # (n_p,)
    g1 = jax.grad(lambda p: 0.5 * jnp.sum(f(data, p) ** 2))(p1)
    P2 = jnp.stack([jnp.stack([p1, p1 * 0.9])] * 2)  # (2, 2, n_p)
    g2 = jax.grad(lambda p: 0.5 * jnp.sum(f(data, p) ** 2))(P2)
    assert g1.shape == p1.shape and g2.shape == P2.shape
    np.testing.assert_allclose(np.asarray(g2[0, 0]), np.asarray(g1),
                               rtol=1e-5, atol=_GG_ATOL)

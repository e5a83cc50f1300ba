"""Linear time-varying (LTV) condensation.

The reference is strictly LTI (``gpad.m:34-63`` builds powers of one A);
LTV prediction matrices extend the same condensed-QP pipeline to
successive-linearization workflows — everything downstream of ``condense``
(dualize, engines, Controller) is dynamics-agnostic, so only the
prediction/disturbance stacks need per-stage transition products.
"""

import dataclasses

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.condense import (
    condense,
    dare_terminal_weight,
    prediction_matrices,
    prediction_matrices_ltv,
)
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.qp import solve_condensed_qp
from tpu_gpad.types import LinearMPCProblem


def _as_lti(problem: LinearMPCProblem, k: int = 0) -> LinearMPCProblem:
    return dataclasses.replace(
        problem, A=np.asarray(problem.A)[k], B=np.asarray(problem.B)[k]
    )


def test_ltv_reduces_to_lti():
    """Stacking N copies of one (A, B) must reproduce prediction_matrices."""
    prob = problems.random_lti(n_x=3, n_u=2, horizon=5, seed=7)
    N = prob.horizon
    T0, S0 = prediction_matrices(prob.A, prob.B, N)
    T1, S1 = prediction_matrices_ltv(
        np.repeat(prob.A[None], N, axis=0), np.repeat(prob.B[None], N, axis=0)
    )
    np.testing.assert_allclose(T1, T0, atol=1e-12)
    np.testing.assert_allclose(S1, S0, atol=1e-12)


def test_ltv_rollout_brute_force(rng):
    """x = T x0 + S z must match stepping x_{k+1} = A_k x_k + B_k u_k."""
    n_x, n_u, N = 3, 2, 6
    A = rng.normal(size=(N, n_x, n_x)) * 0.6
    B = rng.normal(size=(N, n_x, n_u))
    T, S = prediction_matrices_ltv(A, B)
    x0 = rng.normal(size=n_x)
    z = rng.normal(size=n_u * N)
    xs = T @ x0 + S @ z
    x = x0
    for k in range(N):
        x = A[k] @ x + B[k] @ z[k * n_u : (k + 1) * n_u]
        np.testing.assert_allclose(xs[k * n_x : (k + 1) * n_x], x, atol=1e-10)


def test_ltv_condense_parity_with_lti():
    """drift=0 LTV condenses to bit-identical QP data as the LTI path."""
    ltv = problems.random_ltv(n_x=4, n_u=2, horizon=6, seed=3, drift=0.0)
    lti = dataclasses.replace(
        _as_lti(ltv), name=ltv.name
    )
    qp_v = condense(ltv)
    qp_i = condense(lti)
    for field in ("H", "F", "G", "b0", "E"):
        np.testing.assert_allclose(
            getattr(qp_v, field), getattr(qp_i, field), atol=1e-12, err_msg=field
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_ltv_solve_matches_exact_qp(seed):
    problem = problems.random_ltv(n_x=4, n_u=2, horizon=6, seed=seed)
    assert problem.is_ltv
    qp = tpu_gpad.condense(problem)
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    rng = np.random.default_rng(seed + 100)
    X0 = rng.uniform(-1.0, 1.0, size=(6, 4)).astype(np.float32)
    res = solve_batch(data, X0, config=SolverConfig(iterations=400, restart=True))
    checked = 0
    for i in range(X0.shape[0]):
        sol = solve_condensed_qp(qp, X0[i])
        if sol.status != "optimal":
            continue
        checked += 1
        err = np.abs(np.asarray(res.u[i]) - sol.z[: qp.n_u]).max()
        assert err < 5e-4, (seed, i, err)
    assert checked >= 3


def test_ltv_disturbance_stack(rng):
    """process_disturbance S_c must match the offset recurrence
    off_{k+1} = A_k off_k + c for time-varying A."""
    problem = problems.random_ltv(n_x=3, n_u=2, horizon=5, seed=11)
    qp = condense(problem, process_disturbance=True)
    n_x, N = 3, 5
    assert qp.n_x == 2 * n_x  # parameter [x0; c]
    A = np.asarray(problem.A)
    c = rng.normal(size=n_x)
    # brute-force offsets of the predicted states under constant c
    off, offs = np.zeros(n_x), []
    for k in range(N):
        off = A[k] @ off + c
        offs.append(off.copy())
    offs = np.concatenate(offs)
    # state-box rows (upper first): RHS = xmax - T x0 - S_c c, so the
    # disturbance columns of E on those rows are -S_c
    E_c = qp.E[: n_x * N, n_x:]
    np.testing.assert_allclose(E_c @ c, -offs, atol=1e-10)


def test_ltv_tracking_and_rate_compose():
    """LTV composes with the tracking + slew-limit QP extensions."""
    base = problems.random_ltv(n_x=3, n_u=2, horizon=5, seed=5)
    problem = dataclasses.replace(
        base, du_min=np.full(2, -0.4), du_max=np.full(2, 0.4)
    )
    qp = condense(problem, tracking=True)
    assert qp.n_x == 3 + 3 + 2  # [x0; r; u_prev]
    data = tpu_gpad.dualize(qp, iterations=300, paired="auto")
    p = np.concatenate([[0.5, -0.5, 0.2], [0.1, 0.0, -0.1], [0.0, 0.0]])
    res = solve_batch(
        data,
        p[None].astype(np.float32),
        config=SolverConfig(iterations=300, restart=True),
    )
    sol = solve_condensed_qp(qp, p)
    assert sol.status == "optimal"
    err = np.abs(np.asarray(res.u[0]) - sol.z[: qp.n_u]).max()
    assert err < 5e-4


def test_ltv_guards():
    problem = problems.random_ltv(horizon=6, seed=0)
    with pytest.raises(ValueError, match="time-invariant"):
        dare_terminal_weight(problem)
    with pytest.raises(ValueError, match="time-invariant offset-free"):
        tpu_gpad.closed_loop.simulate(problem, np.zeros(4), n_steps=2)
    short = dataclasses.replace(problem, horizon=4)
    with pytest.raises(ValueError, match="stack horizon"):
        condense(short)
    bad_B = dataclasses.replace(
        problem, B=np.asarray(problem.B)[: problem.horizon - 1]
    )
    with pytest.raises(ValueError, match="LTV B"):
        condense(bad_B)


def test_ltv_estimator_guard():
    from tpu_gpad.estimator import OffsetFreeController

    problem = problems.random_ltv(horizon=4, seed=2)
    with pytest.raises(ValueError, match="time-invariant"):
        OffsetFreeController(problem, C=np.eye(4))


# ------------------------------------------------------- per-stage weights


def test_stage_weights_reduce_to_shared():
    """Stacked copies of one (Q, R) condense bit-identically to the
    shared-weight (kron) path."""
    prob0 = problems.random_lti(n_x=3, n_u=2, horizon=5, seed=6)
    N = prob0.horizon
    prob = dataclasses.replace(
        prob0,
        Q=np.repeat(prob0.Q[None], N, axis=0),
        R=np.repeat(prob0.R[None], N, axis=0),
    )
    qp0, qp = condense(prob0), condense(prob)
    np.testing.assert_allclose(qp.H, qp0.H)
    np.testing.assert_allclose(qp.F, qp0.F)


def test_stage_weights_solve_matches_exact_qp(rng):
    """Genuinely time-varying weights (rising state cost toward the tail)
    agree with the exact QP through the device solver."""
    prob0 = problems.random_lti(n_x=4, n_u=2, horizon=6, seed=8)
    N = prob0.horizon
    scale = np.linspace(0.5, 4.0, N)
    prob = dataclasses.replace(
        prob0,
        Q=scale[:, None, None] * prob0.Q[None],
        R=(1.0 / scale)[:, None, None] * prob0.R[None],
    )
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


def test_stage_weights_terminal_and_uref():
    """Q_terminal still replaces the last stacked block; input_reference's
    linear-cost rows carry the PER-STAGE R blocks."""
    prob0 = problems.random_lti(n_x=3, n_u=2, horizon=4, seed=3)
    N = prob0.horizon
    Qs = np.stack([(k + 1.0) * prob0.Q for k in range(N)])
    Rs = np.stack([(k + 1.0) * prob0.R for k in range(N)])
    Q_N = 7.0 * np.eye(3)
    prob = dataclasses.replace(prob0, Q=Qs, R=Rs, Q_terminal=Q_N)
    qp = condense(prob, tracking=True, input_reference=True)
    from tpu_gpad.condense import prediction_matrices

    T, S = prediction_matrices(prob0.A, prob0.B, N)
    Qbar = np.zeros((3 * N, 3 * N))
    for k in range(N):
        Qbar[3 * k : 3 * k + 3, 3 * k : 3 * k + 3] = Qs[k]
    Qbar[-3:, -3:] = Q_N
    Rbar = np.zeros((2 * N, 2 * N))
    for k in range(N):
        Rbar[2 * k : 2 * k + 2, 2 * k : 2 * k + 2] = Rs[k]
    np.testing.assert_allclose(qp.H, S.T @ Qbar @ S + Rbar, atol=1e-10)
    # u_ref parameter rows (last n_u rows of F): -[R_1 .. R_N]
    F_u = qp.F[-2:]
    expect = -np.concatenate([Rs[k] for k in range(N)], axis=1)
    np.testing.assert_allclose(F_u, expect, atol=1e-12)


def test_stage_weights_guards():
    prob0 = problems.random_lti(n_x=3, n_u=2, horizon=4, seed=0)
    bad = dataclasses.replace(prob0, Q=np.repeat(prob0.Q[None], 3, axis=0))
    with pytest.raises(ValueError, match="per-stage Q"):
        condense(bad)
    stacked = dataclasses.replace(
        prob0, R=np.repeat(prob0.R[None], 4, axis=0)
    )
    with pytest.raises(ValueError, match="time-invariant"):
        dare_terminal_weight(stacked)

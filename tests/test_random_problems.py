"""Property tests on random constrained LTI plants.

The reference only exercises the battery problem; these pin the solver's
generality: for random stable plants, GPAD (with restart) must agree with
the exact active-set QP solution wherever the QP is feasible, across
paired/dense layouts and engines.
"""

import numpy as np
import pytest

import tpu_gpad

from tpu_gpad import problems
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.qp import solve_condensed_qp


@pytest.mark.parametrize("seed,coupled", [(0, False), (1, True), (2, False)])
def test_random_plant_matches_exact_qp(seed, coupled):
    problem = problems.random_lti(n_x=4, n_u=2, horizon=6, seed=seed,
                                  coupled=coupled)
    qp = tpu_gpad.condense(problem)
    data = tpu_gpad.dualize(qp, iterations=400, paired="auto")
    assert data.paired  # box stacks always pair

    rng = np.random.default_rng(seed + 100)
    X0 = rng.uniform(-1.0, 1.0, size=(8, 4)).astype(np.float32)
    res = solve_batch(
        data, X0, config=SolverConfig(iterations=400, restart=True)
    )
    checked = 0
    for i in range(X0.shape[0]):
        sol = solve_condensed_qp(qp, X0[i])
        if sol.status != "optimal":
            continue  # infeasible start: no ground truth to compare
        checked += 1
        err = np.abs(np.asarray(res.u[i]) - sol.z[: qp.n_u]).max()
        assert err < 5e-4, (seed, i, err)
    assert checked >= 4  # the box must yield mostly-feasible starts


def test_random_plant_eps_mode_converges():
    problem = problems.random_lti(n_x=3, n_u=2, horizon=5, seed=7)
    data = tpu_gpad.dualize(tpu_gpad.condense(problem), iterations=2000,
                            paired="auto")
    rng = np.random.default_rng(3)
    X0 = rng.uniform(-0.5, 0.5, size=(6, 3)).astype(np.float32)
    res = tpu_gpad.solve_to_accuracy(data, X0, tol=1e-5)
    assert bool(np.all(np.asarray(res.converged)))
    assert np.asarray(res.residual).max() <= 1e-5 + 1e-7


def test_random_plant_closed_loop_regulates():
    """A stable random plant under MPC regulates toward the origin."""
    problem = problems.random_lti(n_x=3, n_u=2, horizon=8, seed=11, rho=0.9)
    x0 = np.asarray([2.0, -1.5, 1.0], dtype=np.float32)
    res = tpu_gpad.simulate(
        problem, x0, n_steps=40, iterations=60,
        config=SolverConfig(iterations=60, restart=True), warm_start=True,
    )
    X = np.asarray(res.X)
    assert np.linalg.norm(X[-1]) < 0.1 * np.linalg.norm(X[0])

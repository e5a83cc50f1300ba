"""Jitted JAX solver vs the NumPy oracle and QP ground truth."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_gpad import problems
from tpu_gpad.condense import condense, dualize
from tpu_gpad.problems.battery import default_x0
from tpu_gpad.solver import solve, solve_batch, SolverConfig
from tpu_gpad.solver.reference import gpad_solve_qp


@pytest.fixture(scope="module")
def battery_setup():
    prob = problems.battery(n_cells=3, horizon=4)
    qp = condense(prob)
    data = dualize(qp, iterations=100)
    return prob, qp, data


def test_matches_numpy_oracle(battery_setup):
    """Same 100 fixed iterations -> identical trajectory to the oracle
    (both fp32, same schedule, same L) to ~1e-5."""
    _, qp, data = battery_setup
    x0 = default_x0(3, seed=0)
    res = solve(data, jnp.asarray(x0, dtype=jnp.float32))
    ref = gpad_solve_qp(qp, x0, iterations=100)
    np.testing.assert_allclose(np.asarray(res.z[0]), ref.z, atol=2e-5)
    np.testing.assert_allclose(np.asarray(res.y[0]), ref.y, atol=2e-5)
    np.testing.assert_allclose(np.asarray(res.u[0]), ref.u, atol=2e-5)


def test_u_star_accuracy(battery_setup):
    """u* within 1e-4 of QP ground truth at a converged budget
    (BASELINE.md north-star tolerance)."""
    from tests.test_oracle import scipy_qp

    _, qp, _ = battery_setup
    data = dualize(qp, iterations=3000)
    x0 = default_x0(3, seed=7)
    res = solve(data, jnp.asarray(x0, dtype=jnp.float32))
    z_ref = scipy_qp(qp, x0)
    np.testing.assert_allclose(np.asarray(res.u[0]), z_ref[:3], atol=1e-4)


def test_batch_matches_single(battery_setup):
    _, qp, data = battery_setup
    rng = np.random.default_rng(42)
    X0 = rng.uniform(-0.5, 0.5, size=(8, 3)).astype(np.float32)
    batch = solve_batch(data, jnp.asarray(X0))
    for i in range(8):
        single = solve(data, jnp.asarray(X0[i]))
        np.testing.assert_allclose(
            np.asarray(batch.u[i]), np.asarray(single.u[0]),
            atol=1e-6,
        )


def test_eps_mode(battery_setup):
    _, qp, _ = battery_setup
    data = dualize(qp, iterations=20000)
    rng = np.random.default_rng(9)
    X0 = rng.uniform(-0.5, 0.5, size=(4, 3)).astype(np.float32)
    cfg = SolverConfig(iterations=20000, mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10)
    res = solve_batch(data, jnp.asarray(X0), config=cfg)
    assert bool(np.all(np.asarray(res.converged)))
    assert int(np.max(np.asarray(res.iterations))) < 20000
    assert float(np.max(np.asarray(res.residual))) <= 1.5e-5
    # iterations are multiples of the check cadence
    assert np.all(np.asarray(res.iterations) % 10 == 0)


def test_eps_matches_fixed_u(battery_setup):
    """eps and fixed modes agree on u* once both are converged."""
    _, qp, _ = battery_setup
    x0 = jnp.asarray(default_x0(3, seed=2), dtype=jnp.float32)
    data = dualize(qp, iterations=8000)
    fixed = solve(data, x0)
    eps = solve(data, x0, config=SolverConfig(iterations=8000, mode="eps",
                                              eps_g=1e-6, eps_V=1e-6))
    np.testing.assert_allclose(np.asarray(eps.u[0]), np.asarray(fixed.u[0]), atol=1e-4)


def test_bf16_matmul_close(battery_setup):
    _, _, data = battery_setup
    x0 = jnp.asarray(default_x0(3, seed=0), dtype=jnp.float32)
    f32 = solve(data, x0)
    bf16 = solve(data, x0, config=SolverConfig(matmul_dtype="bfloat16"))
    np.testing.assert_allclose(np.asarray(bf16.u[0]), np.asarray(f32.u[0]), atol=5e-3)


def test_mass_spring_and_double_integrator():
    for prob, x0 in [
        (problems.double_integrator(horizon=10), np.array([5.0, -1.0])),
        (problems.mass_spring(n_masses=2, horizon=6), np.array([1.0, -1.0, 0.0, 0.0])),
    ]:
        qp = condense(prob)
        data = dualize(qp, iterations=2000)
        res = solve(data, jnp.asarray(x0, dtype=jnp.float32))
        ref = gpad_solve_qp(qp, x0, iterations=2000)
        np.testing.assert_allclose(np.asarray(res.u[0]), ref.u, atol=1e-4)

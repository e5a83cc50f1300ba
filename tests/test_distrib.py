"""Multi-device tests on the 8-way virtual CPU mesh (conftest forces
xla_force_host_platform_device_count=8) — the fake-backend distributed test
strategy the reference has no analogue of (SURVEY.md section 4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_gpad import problems
from tpu_gpad.condense import condense, dualize
from tpu_gpad.parallel import make_mesh, solve_batch_sharded, shard_batch
from tpu_gpad.solver import solve_batch, SolverConfig

# these tests exercise the virtual 8-device CPU mesh of tests/conftest.py
pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device (virtual CPU) mesh"
)


@pytest.fixture(scope="module")
def setup():
    qp = condense(problems.battery(n_cells=3, horizon=4))  # m=56, n_z=12
    data = dualize(qp, iterations=400)
    rng = np.random.default_rng(7)
    X0 = jnp.asarray(rng.uniform(-0.5, 0.5, size=(32, 3)).astype(np.float32))
    return data, X0


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_dp_matches_single_device(setup):
    data, X0 = setup
    mesh = make_mesh(n_data=8)
    ref = solve_batch(data, X0, config=SolverConfig(iterations=100))
    out = solve_batch_sharded(
        data, shard_batch(mesh, X0), SolverConfig(iterations=100), mesh=mesh
    )
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.y), np.asarray(ref.y), atol=1e-5)


def test_tp_matches_single_device(setup):
    data, X0 = setup
    mesh = make_mesh(n_data=1, n_model=8)  # m=56 -> 7 rows per device
    ref = solve_batch(data, X0, config=SolverConfig(iterations=100))
    out = solve_batch_sharded(
        data, X0, SolverConfig(iterations=100), mesh=mesh, model_axis="model"
    )
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.y), np.asarray(ref.y), atol=1e-4)


def test_dp_tp_mixed(setup):
    data, X0 = setup
    mesh = make_mesh(n_data=4, n_model=2)
    ref = solve_batch(data, X0, config=SolverConfig(iterations=100))
    out = solve_batch_sharded(
        data, X0, SolverConfig(iterations=100), mesh=mesh, model_axis="model"
    )
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-4)


def test_eps_mode_collective_stopping(setup):
    data, X0 = setup
    mesh = make_mesh(n_data=8)
    cfg = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10)
    out = solve_batch_sharded(data, shard_batch(mesh, X0), cfg, mesh=mesh)
    ref = solve_batch(data, X0, config=cfg)
    assert bool(np.all(np.asarray(out.converged)))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-4)
    # collective exit: every shard ran until the globally-last scenario
    # converged, so per-scenario first-pass iteration counts still match
    np.testing.assert_array_equal(np.asarray(out.iterations), np.asarray(ref.iterations))


@pytest.fixture(scope="module")
def setup_paired():
    qp = condense(problems.battery(n_cells=3, horizon=4))
    data = dualize(qp, iterations=400, paired=True)
    rng = np.random.default_rng(7)
    X0 = jnp.asarray(rng.uniform(-0.5, 0.5, size=(32, 3)).astype(np.float32))
    return data, X0


def test_eps_pallas_engine_sharded(setup_paired):
    """eps mode through engine="auto" under shard_map scenario DP: the
    all-converged predicate psums over the data axis."""
    data, X0 = setup_paired
    mesh = make_mesh(n_data=8)
    kw = dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
              iterations=200)
    out = solve_batch_sharded(
        data, shard_batch(mesh, X0), SolverConfig(engine="auto", **kw),
        mesh=mesh,
    )
    ref = solve_batch(data, X0, config=SolverConfig(engine="xla", **kw))
    assert bool(np.all(np.asarray(out.converged)))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=2e-4)
    # collective exit: every shard ran until the globally-last scenario
    # converged, so per-scenario first-pass iteration counts still match
    np.testing.assert_array_equal(
        np.asarray(out.iterations), np.asarray(ref.iterations)
    )


def test_eps_pallas_sharded_restart_nondivisible(setup_paired):
    """Sharded eps + adaptive restart + a budget that is NOT a multiple of
    check_every (final partial check window) through engine="auto"."""
    data, X0 = setup_paired
    mesh = make_mesh(n_data=8)
    kw = dict(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
              iterations=195, restart=True)
    out = solve_batch_sharded(
        data, shard_batch(mesh, X0), SolverConfig(engine="auto", **kw),
        mesh=mesh,
    )
    ref = solve_batch(data, X0, config=SolverConfig(engine="xla", **kw))
    assert bool(np.all(np.asarray(out.converged)))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=2e-4)


def test_uneven_batch_raises(setup):
    data, X0 = setup
    mesh = make_mesh(n_data=8)
    with pytest.raises(ValueError, match="not divisible"):
        solve_batch_sharded(data, X0[:30], SolverConfig(iterations=10), mesh=mesh)


def test_tp_nondivisible_m_dense(setup):
    """m=56 over a 3-way model axis: 56 % 3 != 0 — inert-row padding makes
    TP accept any dual dimension (round-2 VERDICT item 7 / SURVEY section 7
    'odd shapes'). u, y and residuals must match the single-device solve."""
    data, X0 = setup
    mesh = make_mesh(n_data=2, n_model=3)
    ref = solve_batch(data, X0, config=SolverConfig(iterations=100))
    out = solve_batch_sharded(
        data, X0, SolverConfig(iterations=100), mesh=mesh, model_axis="model"
    )
    assert out.y.shape == ref.y.shape  # padding sliced back off
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.y), np.asarray(ref.y), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(out.residual), np.asarray(ref.residual), atol=1e-4
    )


def test_tp_nondivisible_m_paired(setup_paired):
    """Paired layout: m_half=28 over a 3-way model axis (28 % 3 == 1)."""
    data, X0 = setup_paired
    mesh = make_mesh(n_data=2, n_model=3)
    ref = solve_batch(data, X0, config=SolverConfig(iterations=100))
    out = solve_batch_sharded(
        data, X0, SolverConfig(iterations=100), mesh=mesh, model_axis="model"
    )
    assert out.y.shape == ref.y.shape
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.y), np.asarray(ref.y), atol=1e-4)


def test_pad_dual_rows_is_inert(setup_paired):
    """pad_dual_rows on a single device: identical u/z/residual/gap to the
    unpadded solve, and the padded dual rows stay exactly zero."""
    from tpu_gpad.parallel import pad_dual_rows

    data, X0 = setup_paired
    padded = pad_dual_rows(data, 5)
    assert padded.m_half == data.m_half + 5
    cfg = SolverConfig(iterations=100)
    ref = solve_batch(data, X0, config=cfg)
    out = solve_batch(padded, X0, config=cfg)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(out.y[..., : data.m_half]), np.asarray(ref.y), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(out.y[..., data.m_half:]), 0.0)
    np.testing.assert_allclose(
        np.asarray(out.residual), np.asarray(ref.residual), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.gap), np.asarray(ref.gap), rtol=1e-5, atol=1e-6
    )

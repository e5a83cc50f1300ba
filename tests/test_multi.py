"""Multi-plant solving: P different QPs in one vmapped device call (the
batched replacement for the reference's per-dataset host loop,
main.cu:104-108 over inputs_manysets)."""

import dataclasses

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.solver import SolverConfig, solve_batch, solve_multi, stack_data


def _plants(n=3, horizon=8, iterations=200):
    datas = []
    for seed in range(n):
        problem = problems.random_lti(
            n_x=3, n_u=2, horizon=horizon, seed=seed
        )
        datas.append(
            tpu_gpad.dualize(
                tpu_gpad.condense(problem),
                iterations=iterations,
                paired="auto",
            )
        )
    return datas


def test_solve_multi_matches_per_plant():
    datas = _plants()
    rng = np.random.default_rng(0)
    X0 = rng.uniform(-0.3, 0.3, size=(3, 4, 3)).astype(np.float32)
    cfg = SolverConfig(iterations=200)
    multi = solve_multi(datas, X0, config=cfg)
    assert multi.u.shape == (3, 4, datas[0].n_u)
    for i, d in enumerate(datas):
        single = solve_batch(d, X0[i], config=cfg)
        np.testing.assert_allclose(
            np.asarray(multi.u[i]), np.asarray(single.u), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(multi.z[i]), np.asarray(single.z), atol=1e-6
        )


def test_solve_multi_eps_mode():
    datas = _plants(iterations=600)
    rng = np.random.default_rng(1)
    X0 = rng.uniform(-0.2, 0.2, size=(3, 4, 3)).astype(np.float32)
    cfg = SolverConfig(
        mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=20,
        iterations=600, restart=True,
    )
    res = solve_multi(datas, X0, config=cfg)
    assert bool(np.asarray(res.converged).all())
    # per-plant iteration counts differ (different conditioning)
    it = np.asarray(res.iterations)
    assert it.shape == (3, 4)


def test_stack_data_validates():
    d8 = _plants(n=1, horizon=8)[0]
    d9 = _plants(n=1, horizon=9)[0]
    with pytest.raises(ValueError, match="horizon"):
        stack_data([d8, d9])
    with pytest.raises(ValueError, match="at least one"):
        stack_data([])
    # schedule-length mismatch is a shape mismatch
    da = _plants(n=1, iterations=100)[0]
    db = _plants(n=1, iterations=200)[0]
    with pytest.raises(ValueError, match="theta"):
        stack_data([da, db])


def test_solve_multi_accepts_prestacked_and_warm_start():
    datas = _plants()
    stacked = stack_data(datas)
    rng = np.random.default_rng(2)
    X0 = rng.uniform(-0.3, 0.3, size=(3, 2, 3)).astype(np.float32)
    cfg = SolverConfig(iterations=200)
    first = solve_multi(stacked, X0, config=cfg)
    warm = solve_multi(stacked, X0, config=cfg, y0=first.y)
    for i, d in enumerate(datas):
        single = solve_batch(d, X0[i], config=cfg, y0=first.y[i])
        np.testing.assert_allclose(
            np.asarray(warm.u[i]), np.asarray(single.u), atol=1e-6
        )


def test_solve_multi_wrong_plant_axis():
    datas = _plants(n=2)
    X0 = np.zeros((3, 4, 3), dtype=np.float32)
    with pytest.raises(ValueError, match="plants"):
        solve_multi(datas, X0, config=SolverConfig(iterations=100))


def test_solve_multi_heterogeneous_limits():
    """Same plant, different input boxes — the u* respect each plant's own
    limits (the constants genuinely differ across the stack)."""
    base = problems.double_integrator(horizon=8)
    datas = []
    for umax in (0.2, 1.0):
        p = dataclasses.replace(
            base,
            u_max=np.full(base.n_u, umax),
            u_min=np.full(base.n_u, -umax),
        )
        datas.append(
            tpu_gpad.dualize(
                tpu_gpad.condense(p), iterations=400, paired="auto"
            )
        )
    X0 = np.tile(np.array([[3.0, 0.0]], dtype=np.float32), (2, 1, 1))
    res = solve_multi(
        datas, X0, config=SolverConfig(iterations=400, restart=True)
    )
    u = np.asarray(res.u)
    assert abs(u[0, 0, 0]) <= 0.2 + 1e-3  # tight box binds
    assert abs(u[1, 0, 0]) > 0.3  # loose box allows a bigger move


def test_solve_multi_sharded_matches_unsharded():
    """8 heterogeneous plants shard over the 8-device mesh; results must
    match the single-device vmapped solve exactly (zero-communication DP)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device (virtual CPU) mesh")
    from tpu_gpad.parallel import make_mesh, solve_multi_sharded

    datas = _plants(n=8)
    stacked = stack_data(datas)
    rng = np.random.default_rng(3)
    X0 = rng.uniform(-0.3, 0.3, size=(8, 4, 3)).astype(np.float32)
    cfg = SolverConfig(iterations=200)
    ref = solve_multi(stacked, X0, config=cfg)
    mesh = make_mesh(8)
    res = solve_multi_sharded(stacked, X0, config=cfg, mesh=mesh)
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(ref.u), atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.z), np.asarray(ref.z), atol=1e-6)


def test_solve_multi_sharded_eps_and_errors():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs a 4-device (virtual CPU) mesh")
    from tpu_gpad.parallel import make_mesh, solve_multi_sharded

    datas = _plants(n=4, iterations=400)
    stacked = stack_data(datas)
    rng = np.random.default_rng(5)
    X0 = rng.uniform(-0.2, 0.2, size=(4, 2, 3)).astype(np.float32)
    cfg = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, iterations=400,
                       restart=True)
    mesh = make_mesh(4)
    res = solve_multi_sharded(stacked, X0, config=cfg, mesh=mesh)
    ref = solve_multi(stacked, X0, config=cfg)
    assert np.asarray(res.converged).all()
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(ref.u), atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        solve_multi_sharded(
            stack_data(_plants(n=3)),
            np.zeros((3, 2, 3), np.float32),
            mesh=mesh,
        )
    with pytest.raises(ValueError, match="stack_data result"):
        solve_multi_sharded(
            _plants(n=1)[0], np.zeros((1, 2, 3), np.float32), mesh=mesh
        )

"""AOT export/reload: the JAX analogue of the reference's prebuilt
solver binary (build/main, SURVEY.md C10) via jax.export."""

import numpy as np

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.aot import export_solver, load_solver
from tpu_gpad.solver import SolverConfig, solve_batch


def _data(iterations=100):
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=10))
    return tpu_gpad.dualize(qp, iterations=iterations, paired="auto")


def test_aot_symbolic_batch_roundtrip(tmp_path):
    data = _data()
    cfg = SolverConfig(iterations=100)
    path = tmp_path / "solver.bin"
    blob = export_solver(data, cfg, path=path)
    assert path.read_bytes() == blob
    solve = load_solver(path)
    rng = np.random.default_rng(0)
    for B in (1, 4, 37):  # symbolic batch serves any size
        X0 = rng.uniform(-0.4, 0.4, (B, 3)).astype(np.float32)
        out = solve(X0)
        ref = solve_batch(data, X0, config=cfg)
        np.testing.assert_allclose(
            np.asarray(out["u"]), np.asarray(ref.u), atol=2e-6
        )
    assert out["u"].shape == (37, data.n_u)


def test_aot_concrete_batch():
    data = _data()
    cfg = SolverConfig(iterations=100)
    blob = export_solver(data, cfg, batch_size=8)
    solve = load_solver(blob)
    X0 = np.random.default_rng(1).uniform(-0.4, 0.4, (8, 3)).astype(np.float32)
    ref = solve_batch(data, X0, config=cfg)
    np.testing.assert_allclose(
        np.asarray(solve(X0)["u"]), np.asarray(ref.u), atol=2e-6
    )


def test_aot_eps_mode():
    data = _data(iterations=500)
    cfg = SolverConfig(
        mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=20,
        iterations=500, restart=True,
    )
    solve = load_solver(export_solver(data, cfg))
    X0 = np.random.default_rng(2).uniform(-0.3, 0.3, (6, 3)).astype(np.float32)
    out = solve(X0)
    assert bool(np.asarray(out["converged"]).all())
    ref = solve_batch(data, X0, config=cfg)
    np.testing.assert_allclose(
        np.asarray(out["u"]), np.asarray(ref.u), atol=2e-6
    )
    np.testing.assert_array_equal(
        np.asarray(out["iterations"]), np.asarray(ref.iterations)
    )


def test_aot_stagewise_export_roundtrip(tmp_path):
    """The long-horizon deployable: a StagewiseData artifact serves any
    batch via the XLA stage-wise executor after reload (symbolic batch),
    matching the live engine."""
    from tpu_gpad.aot import export_stagewise_solver
    from tpu_gpad.stagewise import build_stagewise, solve_stagewise

    prob = problems.battery(n_cells=3, horizon=12)
    data = build_stagewise(prob, iterations=120)
    cfg = SolverConfig(iterations=120)
    path = tmp_path / "stagewise.bin"
    export_stagewise_solver(data, cfg, path=path)
    solve = load_solver(path)
    rng = np.random.default_rng(1)
    for B in (1, 5):
        X0 = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
        out = solve(X0)
        ref = solve_stagewise(data, X0, config=cfg)
        np.testing.assert_allclose(
            np.asarray(out["u"]), np.asarray(ref.u), atol=2e-6
        )
    assert out["y"].shape == (5, 12, data.m_x + data.m_u)

"""Adaptive (O'Donoghue-Candes) momentum restart — no reference analogue.

Gradient-based restart turns GPAD's O(1/k^2) tail into effectively linear
convergence on the bundled MPC duals; these tests pin that property and
cross-check the batched engines against the NumPy oracle.
"""

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.reference import gpad_solve_qp
from tpu_gpad.solver.qp import solve_condensed_qp



@pytest.fixture(scope="module")
def setup():
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=10))
    data = tpu_gpad.dualize(qp, iterations=100, paired="auto")
    rng = np.random.default_rng(7)
    X0 = rng.uniform(-0.4, 0.4, size=(6, 3)).astype(np.float32)
    return qp, data, X0


def test_restart_reaches_exact_optimum_in_fixed_budget(setup):
    """100 restart iterations land on the true optimum (fp32 precision)
    where the plain schedule is still ~1e-3 away."""
    qp, data, X0 = setup
    cfg = SolverConfig(iterations=100, restart=True)
    res = solve_batch(data, X0, config=cfg)
    plain = solve_batch(data, X0, config=SolverConfig(iterations=100))
    for i in range(X0.shape[0]):
        exact = solve_condensed_qp(qp, X0[i]).z[: qp.n_u]
        err_r = np.abs(np.asarray(res.u[i]) - exact).max()
        err_p = np.abs(np.asarray(plain.u[i]) - exact).max()
        assert err_r < 5e-6, (i, err_r)
        assert err_r < max(err_p, 1e-6)


def test_restart_matches_oracle(setup):
    qp, data, X0 = setup
    cfg = SolverConfig(iterations=80, restart=True)
    res = solve_batch(data, X0, config=cfg)
    for i in range(3):
        ref = gpad_solve_qp(qp, X0[i], iterations=80, restart=True)
        np.testing.assert_allclose(
            np.asarray(res.u[i]), ref.u, atol=2e-5
        )


def test_restart_dual_and_mvp_forms_agree(setup):
    qp, data, X0 = setup
    r_dual = solve_batch(
        data, X0, config=SolverConfig(iterations=80, restart=True, form="dual")
    )
    r_mvp = solve_batch(
        data, X0, config=SolverConfig(iterations=80, restart=True, form="mvp")
    )
    np.testing.assert_allclose(
        np.asarray(r_dual.u), np.asarray(r_mvp.u), atol=2e-5
    )


def test_restart_eps_mode_converges_faster(setup):
    qp, data, X0 = setup
    data_long = tpu_gpad.dualize(qp, iterations=1000, paired="auto")
    kw = dict(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
              iterations=1000)
    plain = solve_batch(data_long, X0, config=SolverConfig(**kw))
    fast = solve_batch(data_long, X0, config=SolverConfig(restart=True, **kw))
    assert bool(np.all(np.asarray(fast.converged)))
    it_f = int(np.asarray(fast.iterations).max())
    it_p = int(np.asarray(plain.iterations).max())
    assert it_f < it_p, (it_f, it_p)


def test_restart_budget_not_limited_by_schedule(setup):
    """restart ignores the shipped schedule, so iterations may exceed it."""
    qp, data, X0 = setup
    res = solve_batch(
        data, X0[:2], config=SolverConfig(iterations=150, restart=True)
    )
    assert np.all(np.isfinite(np.asarray(res.u)))
    with pytest.raises(ValueError, match="schedule"):
        solve_batch(data, X0[:2], config=SolverConfig(iterations=150))


def test_restart_pallas_dual_matches_xla(setup, interpret_kernel):
    """The fused dual kernel carries the per-scenario restart recursion."""
    qp, data, X0 = setup
    kw = dict(iterations=80, restart=True)
    r_pl = solve_batch(data, X0, config=SolverConfig(engine="pallas", **kw))
    r_xla = solve_batch(data, X0, config=SolverConfig(engine="xla", **kw))
    np.testing.assert_allclose(
        np.asarray(r_pl.u), np.asarray(r_xla.u), atol=5e-5
    )
    for i in range(X0.shape[0]):
        exact = solve_condensed_qp(qp, X0[i]).z[: qp.n_u]
        assert np.abs(np.asarray(r_pl.u[i]) - exact).max() < 1e-5


def test_restart_pallas_eps_chunked(setup, interpret_kernel):
    """eps + restart has no kernel: engine="auto" takes the XLA while loop
    even where the fixed-mode solve would take the fused kernel."""
    from tpu_gpad.solver.core import resolve_engine

    qp, data, X0 = setup
    data_long = tpu_gpad.dualize(qp, iterations=1000, paired="auto")
    kw = dict(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
              iterations=1000, restart=True)
    assert resolve_engine(data_long, SolverConfig(iterations=100, restart=True)) == "pallas"
    assert resolve_engine(data_long, SolverConfig(**kw)) == "xla"
    r_pl = solve_batch(data_long, X0, config=SolverConfig(engine="auto", **kw))
    r_xla = solve_batch(data_long, X0, config=SolverConfig(engine="xla", **kw))
    assert bool(np.all(np.asarray(r_pl.converged)))
    np.testing.assert_array_equal(
        np.asarray(r_pl.iterations), np.asarray(r_xla.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(r_pl.u), np.asarray(r_xla.u), atol=2e-4
    )


def test_restart_rejected_by_pallas_mvp(setup):
    qp, _, X0 = setup
    dense = tpu_gpad.dualize(qp, iterations=100, paired=False)
    with pytest.raises(ValueError, match="paired"):
        solve_batch(
            dense, X0,
            config=SolverConfig(iterations=50, restart=True, engine="pallas"),
        )


def test_solve_to_accuracy(setup):
    qp, data, X0 = setup
    res = tpu_gpad.solve_to_accuracy(data, X0, tol=1e-5)
    assert bool(np.all(np.asarray(res.converged)))
    assert np.asarray(res.residual).max() <= 1e-5 + 1e-7
    for i in range(2):
        exact = solve_condensed_qp(qp, X0[i]).z[: qp.n_u]
        assert np.abs(np.asarray(res.u[i]) - exact).max() < 1e-4
    # single-scenario form
    r1 = tpu_gpad.solve_to_accuracy(data, X0[0], tol=1e-5)
    np.testing.assert_allclose(
        np.asarray(r1.u[0]), np.asarray(res.u[0]), atol=1e-6
    )


def test_solve_to_accuracy_honors_small_budget(setup):
    """max_iterations below check_every must cap, not inflate, the budget."""
    qp, data, X0 = setup
    res = tpu_gpad.solve_to_accuracy(data, X0[:2], tol=1e-5,
                                     max_iterations=5, check_every=64)
    assert int(np.asarray(res.iterations).max()) <= 5

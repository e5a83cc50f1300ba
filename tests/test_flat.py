"""Flat (identity-block) structure exploitation — the XLA analogue of the
reference's flat kernels (``seq_functions.cpp:5-43``,
``kernel_functions.cu:74-109`` StepFourGPADFlatParRows).

``dualize`` reorders the paired half stack so the input-box rows (exactly
I_{n_z}) come last; the mvp iteration then skips their step-4 matmul
columns (``GL_T[:, n_struct:] == I/L``)."""

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.core import resolve_flat
from tpu_gpad.solver.reference import gpad_solve_qp



@pytest.fixture(scope="module")
def flat_data():
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=10))
    data = tpu_gpad.dualize(qp, iterations=200, paired=True)
    return qp, data


def _x0(n, n_x, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.4, 0.4, size=(n, n_x)).astype(np.float32)


def test_flat_layout_detected(flat_data):
    qp, data = flat_data
    # battery half stack: state-box rows (n_x*N) + coupling (N) structured,
    # input-box rows (n_z) are the identity block
    assert data.n_struct == data.m_half - data.n_z
    ns = data.n_struct
    L = float(np.asarray(data.L))
    # GL_T box columns are exactly I/L; MG_T box rows are H^-1 rows
    np.testing.assert_allclose(
        np.asarray(data.GL_T)[:, ns:] * L, np.eye(data.n_z), atol=1e-6
    )
    Hinv = np.linalg.inv(np.asarray(qp.H, dtype=np.float64))
    np.testing.assert_allclose(
        np.asarray(data.MG_T)[ns:], Hinv, atol=1e-4
    )


def test_flat_detected_across_problems():
    for problem in (
        problems.double_integrator(horizon=8),
        problems.mass_spring(n_masses=3, horizon=6),
        problems.battery(n_cells=4, horizon=6),
    ):
        qp = tpu_gpad.condense(problem)
        data = tpu_gpad.dualize(qp, iterations=10, paired="auto")
        if data.paired:
            assert data.n_struct is not None
            assert 0 < data.n_struct < data.m_half


def test_flat_on_off_parity_fixed(flat_data):
    """flat='on' and flat='off' are the same math, different flop path."""
    qp, data = flat_data
    X0 = _x0(8, qp.n_x)
    kw = dict(iterations=80, engine="xla", form="mvp")
    r_on = solve_batch(data, X0, config=SolverConfig(flat="on", **kw))
    r_off = solve_batch(data, X0, config=SolverConfig(flat="off", **kw))
    np.testing.assert_allclose(
        np.asarray(r_on.u), np.asarray(r_off.u),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(r_on.y), np.asarray(r_off.y),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(r_on.residual), np.asarray(r_off.residual),
        atol=1e-6,
    )


def test_flat_oracle_parity(flat_data):
    """The row reorder must not change u* (the oracle works on the
    unreordered qp)."""
    qp, data = flat_data
    X0 = _x0(3, qp.n_x, seed=3)
    res = solve_batch(
        data, X0,
        config=SolverConfig(iterations=200, engine="xla", form="mvp", flat="on"),
    )
    for i in range(X0.shape[0]):
        ref = gpad_solve_qp(qp, X0[i].astype(np.float64), iterations=200)
        np.testing.assert_allclose(
            np.asarray(res.u[i]), ref.u, atol=1e-4
        )


def test_flat_eps_mode(flat_data):
    qp, data = flat_data
    X0 = _x0(6, qp.n_x, seed=5)
    kw = dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
              iterations=200, engine="xla", form="mvp")
    r_on = solve_batch(data, X0, config=SolverConfig(flat="on", **kw))
    r_off = solve_batch(data, X0, config=SolverConfig(flat="off", **kw))
    np.testing.assert_array_equal(
        np.asarray(r_on.iterations), np.asarray(r_off.iterations)
    )
    np.testing.assert_allclose(
        np.asarray(r_on.u), np.asarray(r_off.u), atol=1e-5
    )
    assert bool(np.all(np.asarray(r_on.converged)))


def test_flat_resolver(flat_data):
    qp, data = flat_data
    assert resolve_flat(data, SolverConfig()) is True  # auto, detected
    assert resolve_flat(data, SolverConfig(flat="off")) is False
    # TP shards GL_T columns: flat unavailable
    assert resolve_flat(data, SolverConfig(model_axis="model")) is False
    with pytest.raises(ValueError, match="flat='on'"):
        resolve_flat(data, SolverConfig(flat="on", model_axis="model"))
    # unpaired data has no identity-block hint
    data_dense = tpu_gpad.dualize(qp, iterations=10, paired=False)
    assert data_dense.n_struct is None
    assert resolve_flat(data_dense, SolverConfig()) is False


def test_flat_pallas_kernel_matches_xla(flat_data):
    """The flat mvp loop (identity block as a scalar multiply) agrees with
    the dense paired mvp loop and the dual form, cold and warm."""
    qp, data = flat_data
    X0 = _x0(6, qp.n_x, seed=9)
    cfg_flat = SolverConfig(iterations=60, engine="xla", form="mvp", flat="on")
    cfg_dense = SolverConfig(iterations=60, engine="xla", form="mvp", flat="off")
    cfg_dual = SolverConfig(iterations=60, engine="xla", form="dual")
    r_flat = solve_batch(data, X0, config=cfg_flat)
    for cfg in (cfg_dense, cfg_dual):
        r = solve_batch(data, X0, config=cfg)
        np.testing.assert_allclose(np.asarray(r_flat.z), np.asarray(r.z), atol=2e-5)
        np.testing.assert_allclose(np.asarray(r_flat.y), np.asarray(r.y), atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(r_flat.residual), np.asarray(r.residual), atol=2e-5
        )
    # warm start through the flat layout
    w_flat = solve_batch(data, X0, config=cfg_flat, y0=r_flat.y)
    w_dense = solve_batch(data, X0, config=cfg_dense, y0=r_flat.y)
    np.testing.assert_allclose(np.asarray(w_flat.u), np.asarray(w_dense.u), atol=2e-5)
    assert np.abs(np.asarray(w_flat.y) - np.asarray(r_flat.y)).max() > 1e-6


def test_flat_pallas_high_precision(flat_data):
    """precision='high' through the flat loop tracks the dense loop."""
    qp, data = flat_data
    X0 = _x0(4, qp.n_x, seed=11)
    r_flat = solve_batch(
        data, X0,
        config=SolverConfig(
            iterations=60, engine="xla", form="mvp", flat="on", precision="high"
        ),
    )
    r_dense = solve_batch(
        data, X0,
        config=SolverConfig(
            iterations=60, engine="xla", form="mvp", flat="off", precision="high"
        ),
    )
    np.testing.assert_allclose(np.asarray(r_flat.u), np.asarray(r_dense.u), atol=1e-4)


def test_flat_kernel_off_when_flat_off(flat_data):
    """flat='off' runs the dense paired product; both agree."""
    from tpu_gpad.solver.core import resolve_flat

    qp, data = flat_data
    X0 = _x0(3, qp.n_x, seed=13)
    cfg_off = SolverConfig(iterations=40, form="mvp", flat="off")
    cfg_on = SolverConfig(iterations=40, form="mvp")
    assert not resolve_flat(data, cfg_off) and resolve_flat(data, cfg_on)
    r_off = solve_batch(data, X0, config=cfg_off)
    r_on = solve_batch(data, X0, config=cfg_on)
    np.testing.assert_allclose(np.asarray(r_on.u), np.asarray(r_off.u), atol=2e-5)


def test_flat_flops_accounting(flat_data):
    from tpu_gpad.utils import solve_flops

    qp, data = flat_data
    dense = solve_flops(data, 100, "mvp", flat=False)
    flat = solve_flops(data, 100, "mvp", flat=True)
    # the step-4 cut is 2*n_z*(m_h - n_struct) = 2*n_z^2 per iteration
    assert dense - flat == 100 * (2 * data.n_z * data.n_z - data.n_z)

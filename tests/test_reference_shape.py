"""Full-solver parity at the reference's flagship dataset shape.

The largest committed fixture and the ``inputs_manysets`` datasets use
n_u=30, N=30, m=3660 (``build/step3/4/input.txt`` header; SURVEY.md C9).
The fused dual kernel declines this size and the XLA engine takes it.
"""

import numpy as np

import tpu_gpad

from tpu_gpad import problems
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.reference import gpad_solve_qp


def test_reference_shape_dims_and_parity():
    problem = problems.battery(n_cells=30, horizon=30)
    qp = tpu_gpad.condense(problem)
    assert qp.n_z == 900
    assert qp.m == 4 * 30 * 30 + 2 * 30  # == 3660, the reference's law

    data = tpu_gpad.dualize(qp, iterations=60, paired="auto")
    rng = np.random.default_rng(5)
    X0 = rng.uniform(-0.3, 0.3, size=(2, 30)).astype(np.float32)
    res = solve_batch(data, X0, config=SolverConfig(iterations=60))
    for i in range(2):
        ref = gpad_solve_qp(qp, X0[i].astype(np.float64), iterations=60)
        np.testing.assert_allclose(
            np.asarray(res.u[i]), ref.u, atol=1e-4
        )


def test_reference_shape_routing(monkeypatch):
    """Routing at the reference's flagship shape (m_half=1830): the XLA
    dual loop, on any backend — the fused kernel admits m_half <= 144
    (measured on an H100: at this size the product is a real GEMM for
    cuBLAS, and the dual form beat the flat mvp form 10.2 vs 11.3 ms per
    B=256 batch). eps mode runs the XLA while loop."""
    from tpu_gpad.solver import kernels
    from tpu_gpad.solver.core import resolve_engine, resolve_form

    qp = tpu_gpad.condense(problems.battery(n_cells=30, horizon=30))
    data = tpu_gpad.dualize(qp, iterations=10, paired="auto")
    assert data.n_struct == data.m_half - data.n_z
    cfg = SolverConfig(iterations=10)
    ok, why = kernels.admits(data, cfg)
    assert not ok and "MAX_DUAL_ROWS" in why
    monkeypatch.setattr(kernels, "on_gpu", lambda: True)
    assert resolve_form(data, cfg) == "dual"
    assert resolve_engine(data, cfg) == "xla"
    cfg_dual = SolverConfig(iterations=10, form="dual")
    assert resolve_engine(data, cfg_dual) == "xla"
    cfg_eps = SolverConfig(mode="eps", iterations=100, check_every=10)
    assert resolve_engine(data, cfg_eps) == "xla"
    cfg_eps_nf = SolverConfig(
        mode="eps", iterations=100, check_every=10, flat="off"
    )
    assert resolve_engine(data, cfg_eps_nf) == "xla"

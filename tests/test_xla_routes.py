"""The XLA routes at the shapes whose former accelerator-specific kernels
were removed: oversized duals, the mvp forms (flat and dense), and the
stage-wise sweeps. Condensed routes are checked against the NumPy oracle,
the stage-wise engine against the condensed engine on the same QP."""

import dataclasses

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.solver.core import resolve_engine, resolve_flat, resolve_form
from tpu_gpad.solver.reference import gpad_solve_qp
from tpu_gpad.stagewise import build_stagewise, solve_stagewise


@pytest.mark.parametrize(
    "n, N, kw, form, flat",
    [
        (3, 10, {}, "dual", False),
        (3, 20, {}, "dual", False),
        (3, 10, dict(form="mvp"), "mvp", True),
        (8, 8, dict(form="mvp"), "mvp", True),
        (3, 10, dict(form="mvp", flat="off"), "mvp", False),
    ],
    ids=["dual_n3N10", "dual_n3N20", "flat_mvp_n3N10", "flat_mvp_n8N8",
         "dense_mvp_n3N10"],
)
def test_xla_route_matches_oracle(n, N, kw, form, flat):
    qp = tpu_gpad.condense(problems.battery(n_cells=n, horizon=N))
    data = tpu_gpad.dualize(qp, iterations=100, paired="auto")
    cfg = SolverConfig(iterations=100, **kw)
    assert resolve_engine(data, cfg) == "xla"
    assert resolve_form(data, cfg) == form
    assert (form == "mvp" and resolve_flat(data, cfg)) == flat
    X0 = np.random.default_rng(n * N).uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    res = solve_batch(data, X0, config=cfg)
    for i in range(3):
        ref = gpad_solve_qp(qp, X0[i].astype(np.float64), iterations=100)
        np.testing.assert_allclose(np.asarray(res.u[i]), ref.u, atol=1e-4)


@pytest.mark.parametrize(
    "make",
    [
        lambda: problems.battery(3, 8),
        lambda: problems.random_ltv(n_x=3, n_u=2, horizon=6, seed=3),
        lambda: problems.battery(8, 12),
        lambda: problems.battery(30, 8),
        lambda: problems.double_integrator(horizon=8),
        lambda: dataclasses.replace(problems.battery(3, 7),
                                    c=np.array([0.02, -0.01, 0.015])),
    ],
    ids=["battery_n3N8", "random_ltv", "battery_n8N12", "battery_n30N8",
         "double_integrator", "battery_affine"],
)
@pytest.mark.parametrize("scan", ["sequential", "associative"])
def test_stagewise_sweeps_match_condensed(make, scan):
    prob = make()
    cfg = SolverConfig(iterations=200, restart=True)
    data_s = build_stagewise(prob, iterations=200)
    data_c = tpu_gpad.dualize(tpu_gpad.condense(prob), iterations=200,
                              paired="auto")
    X0 = np.random.default_rng(1).uniform(-0.3, 0.3, (4, prob.n_x)).astype(np.float32)
    r_s = solve_stagewise(data_s, X0, config=cfg, scan=scan)
    r_c = solve_batch(data_c, X0, config=cfg)
    np.testing.assert_allclose(np.asarray(r_s.u), np.asarray(r_c.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(r_s.z), np.asarray(r_c.z), atol=1e-4)

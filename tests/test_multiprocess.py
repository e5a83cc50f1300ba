"""Two-process jax.distributed test — the multi-host/DCN code path.

Everything else in tests/ runs a SINGLE process with 8 virtual devices;
here two fresh interpreters (4 virtual CPU devices each) form one global
8-device mesh through a localhost TCP coordinator, run
``solve_batch_sharded`` in fixed and eps modes across the process boundary,
and the parent asserts parity with its own single-process solve
(SURVEY.md:250-252 — the fake-backend distributed test the reference lacks).
"""

import numpy as np

from tpu_gpad.parallel.mp_worker import run_multiprocess_check


def test_two_process_distributed(tmp_path):
    out_path = tmp_path / "mp_out.npz"
    run_multiprocess_check(
        num_processes=2, local_devices=4, out_path=str(out_path)
    )
    got = np.load(out_path)

    # single-process reference on the identical problem/batch
    import tpu_gpad
    from tpu_gpad import problems
    from tpu_gpad.solver import SolverConfig, solve_batch

    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=4))
    data = tpu_gpad.dualize(qp, iterations=400, paired=True)
    X0 = got["X0"]
    ref = solve_batch(data, X0, config=SolverConfig(iterations=100))
    np.testing.assert_allclose(
        got["u_fixed"], np.asarray(ref.u), atol=1e-5
    )

    cfg_eps = SolverConfig(
        mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
        iterations=400, restart=True,
    )
    ref_eps = solve_batch(data, X0, config=cfg_eps)
    np.testing.assert_allclose(got["u_eps"], np.asarray(ref_eps.u), atol=1e-5)
    # the collective stopping test spans processes: per-scenario first-pass
    # iteration counts must match the single-process run exactly
    np.testing.assert_array_equal(
        got["iters_eps"], np.asarray(ref_eps.iterations)
    )

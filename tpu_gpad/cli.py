"""Command-line entry points: ``python -m tpu_gpad <command>``.

The runtime equivalent of the reference's executables: ``solve`` plays the
role of the CUDA solver binary (``Code/CUDA/FinalProject/main.cu:79-207``
reads a dataset file, runs the fixed-iteration loop, prints dims + timing),
``closedloop`` plays ``Code/MATLAB/gpad.m``'s 1000-sample controller loop,
``sweep`` is the checkpointed large-batch runner, and ``export`` writes
problems out in the reference's ``input_%d.txt`` text format for interop.

All output is structured JSON (one object per line) instead of the
reference's printf logging (``main.cu:188-190``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _build_problem(args) -> "LinearMPCProblem":
    from tpu_gpad import problems

    if args.problem == "battery":
        return problems.battery(n_cells=args.cells, horizon=args.horizon)
    if args.problem == "double_integrator":
        return problems.double_integrator(horizon=args.horizon)
    if args.problem == "mass_spring":
        return problems.mass_spring(n_masses=args.cells, horizon=args.horizon)
    raise SystemExit(f"unknown problem: {args.problem!r}")


def _add_problem_args(p):
    p.add_argument("--problem", default="battery",
                   choices=["battery", "double_integrator", "mass_spring"])
    p.add_argument("--cells", type=int, default=3,
                   help="n_cells (battery) / n_masses (mass_spring)")
    p.add_argument("--horizon", type=int, default=10, help="prediction horizon N")


def _add_solver_args(p):
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--mode", default="fixed", choices=["fixed", "eps"])
    p.add_argument("--eps-g", type=float, default=1e-6)
    p.add_argument("--eps-v", type=float, default=1e-6)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "pallas", "stagewise"],
                   help="condensed engines (auto/xla/pallas) or the O(N) "
                        "non-condensed stage-wise engine (long horizons; "
                        "docs/DESIGN.md section 11)")
    p.add_argument("--form", default="auto", choices=["auto", "mvp", "dual"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="operand dtype for the hot matmuls")
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="fp32 matmul precision: true fp32 / high / TF32 "
                        "allowed (the XLA loop then runs TF32, u* ~1e-3; the "
                        "fused kernel stays full fp32) — docs/DESIGN.md "
                        "section 8")
    p.add_argument("--flat", default="auto", choices=["auto", "on", "off"],
                   help="exploit the input-box identity block in the mvp "
                        "form (the reference's flat kernels)")
    p.add_argument("--restart", action="store_true",
                   help="adaptive momentum restart (near-linear convergence; "
                        "certified iteration bounds no longer apply)")
    p.add_argument("--paired", default="auto", choices=["auto", "on", "off"],
                   help="half-stack [P;-P] layout (halves MVP flops)")


def _reject_stagewise(args, where: str) -> None:
    """Condensed-only subcommands must not silently remap a FORCED
    engine=stagewise to the condensed auto path (project invariant:
    forced engines work or raise)."""
    if getattr(args, "engine", "auto") == "stagewise":
        raise SystemExit(
            f"--engine stagewise is not supported by `{where}` (it is a "
            "solve-time engine; use `solve --engine stagewise`, or drop "
            "the flag to let the condensed auto engine route)"
        )


def _solver_config(args):
    """Build a SolverConfig from parsed args; subcommands that expose only
    a subset of the solver flags (e.g. ``info``) fall back to defaults."""
    from tpu_gpad.solver import SolverConfig

    engine = getattr(args, "engine", "auto")
    return SolverConfig(
        iterations=args.iterations,
        mode=getattr(args, "mode", "fixed"),
        eps_g=getattr(args, "eps_g", 1e-6),
        eps_V=getattr(args, "eps_v", 1e-6),
        # the stage-wise engine is routed before condensation (cmd_solve);
        # the condensed config never sees it
        engine="auto" if engine == "stagewise" else engine,
        form=getattr(args, "form", "auto"),
        matmul_dtype=getattr(args, "dtype", "float32"),
        precision=getattr(args, "precision", "highest"),
        flat=getattr(args, "flat", "auto"),
        restart=getattr(args, "restart", False),
    )


def _paired(args):
    return {"auto": "auto", "on": True, "off": False}[args.paired]


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _scenarios(args, n_x: int) -> np.ndarray:
    """(batch, n_x) initial states: file, or seeded random box samples."""
    if getattr(args, "x0", None):
        X0 = np.loadtxt(args.x0, dtype=np.float32, ndmin=2)
        if X0.shape[1] != n_x:
            raise SystemExit(f"--x0 file has {X0.shape[1]} columns, expected {n_x}")
        return X0
    rng = np.random.default_rng(args.seed)
    return rng.uniform(-0.4, 0.4, size=(args.batch, n_x)).astype(np.float32)


def cmd_solve(args) -> int:
    import jax.numpy as jnp

    import tpu_gpad
    from tpu_gpad.utils import device_time_per_call

    config = _solver_config(args)
    if args.dataset:
        _reject_stagewise(args, "solve --dataset")
        from tpu_gpad.io import read_solver_dataset, dataset_to_gpad_data

        ds = read_solver_dataset(args.dataset)
        if args.iterations > ds.num_iterations:
            config = __import__("dataclasses").replace(
                config, iterations=ds.num_iterations)
        data = dataset_to_gpad_data(ds)
        X0 = np.zeros((1, 1), dtype=np.float32)  # parameter baked into the file
    elif args.engine == "stagewise":
        from tpu_gpad.stagewise import build_stagewise, solve_stagewise

        problem = _build_problem(args)
        data = build_stagewise(problem, iterations=args.iterations)
        X0 = _scenarios(args, problem.n_x)
        X0j = jnp.asarray(X0)
        res = solve_stagewise(data, X0j, config=config)
        out = {
            "problem": data.name, "engine": "stagewise",
            "n_u": data.n_u, "horizon": data.horizon, "m": data.m,
            "batch": int(X0.shape[0]),
            "iterations": int(np.max(np.asarray(res.iterations))),
            "residual_max": float(np.max(np.asarray(res.residual))),
            "converged_all": bool(np.all(np.asarray(res.converged))),
            "u_star": np.asarray(res.u[0]).tolist(),
        }
        if args.time:
            import jax as _jax

            # time a JITTED wrapper with X0 as an argument: the un-jitted
            # path re-traces the 2N-step scan on every call
            jsolve = _jax.jit(
                lambda X: solve_stagewise(data, X, config=config).u)
            t = device_time_per_call(lambda: jsolve(X0j))
            out["batch_device_us"] = t * 1e6
            out["device_us_per_solve"] = t * 1e6 / X0.shape[0]
            out["solves_per_sec"] = X0.shape[0] / t
        _emit(out)
        return 0
    else:
        problem = _build_problem(args)
        data = tpu_gpad.dualize(
            tpu_gpad.condense(problem),
            iterations=args.iterations,
            paired=_paired(args),
        )
        X0 = _scenarios(args, problem.n_x)

    X0j = jnp.asarray(X0)
    res = tpu_gpad.solve_batch(data, X0j, config=config)
    out = {
        "problem": data.name,
        "n_u": data.n_u, "horizon": data.horizon,
        "n_z": data.n_z, "m": data.m,
        "batch": int(X0.shape[0]),
        "iterations": int(np.max(np.asarray(res.iterations))),
        "residual_max": float(np.max(np.asarray(res.residual))),
        "converged_all": bool(np.all(np.asarray(res.converged))),
        "u_star": np.asarray(res.u[0]).tolist(),
    }
    if args.time:
        t = device_time_per_call(
            lambda: tpu_gpad.solve_batch(data, X0j, config=config).u)
        # the reference reports avg+total microseconds over the run
        # (main.cu:188-190); we report per-solve and per-iteration device time
        out["batch_device_us"] = t * 1e6
        out["device_us_per_solve"] = t * 1e6 / X0.shape[0]
        out["device_us_per_iteration"] = t * 1e6 / max(out["iterations"], 1)
        out["solves_per_sec"] = X0.shape[0] / t
    _emit(out)
    return 0


def cmd_closedloop(args) -> int:
    from tpu_gpad.closed_loop import simulate, plot_closed_loop
    from tpu_gpad.problems.battery import default_x0

    _reject_stagewise(args, "closedloop")
    problem = _build_problem(args)
    config = _solver_config(args)
    if args.x0 or args.batch > 1:
        X0 = _scenarios(args, problem.n_x)
    else:
        X0 = (default_x0(args.cells, seed=args.seed)
              if args.problem == "battery"
              else _scenarios(args, problem.n_x)[0])
    result = simulate(
        problem, X0, n_steps=args.steps, config=config,
        iterations=args.iterations, warm_start=args.warm_start,
        paired=_paired(args),
    )
    X = np.asarray(result.X)
    _emit({
        "problem": problem.name,
        "steps": args.steps,
        "warm_start": args.warm_start,
        "final_state": X[-1].tolist() if X.ndim == 2 else X[-1, 0].tolist(),
        "max_residual": float(np.max(np.asarray(result.residual))),
        "mean_iterations": float(np.mean(np.asarray(result.iterations))),
    })
    if args.plot:
        plot_closed_loop(result, path=args.plot)
        _emit({"plot": args.plot})
    return 0


def cmd_sweep(args) -> int:
    import tpu_gpad
    from tpu_gpad.sweep import run_sweep

    _reject_stagewise(args, "sweep")
    problem = _build_problem(args)
    data = tpu_gpad.dualize(
        tpu_gpad.condense(problem), iterations=args.iterations,
        paired=_paired(args))
    X0 = _scenarios(args, problem.n_x)
    solve_fn = None
    if args.sharded:
        import jax
        import numpy as _np

        from tpu_gpad.parallel import make_mesh, solve_batch_sharded

        mesh = make_mesh()
        n_data = mesh.shape["data"]

        def solve_fn(d, x, c):
            # pad the (possibly ragged last) chunk to the mesh width
            pad = (-x.shape[0]) % n_data
            xp = _np.pad(x, ((0, pad), (0, 0))) if pad else x
            res = solve_batch_sharded(d, xp, c, mesh=mesh)
            if pad:
                res = jax.tree.map(lambda a: a[: x.shape[0]], res)
            return res

    out = run_sweep(
        data, X0, _solver_config(args),
        chunk_size=args.chunk_size, checkpoint=args.checkpoint,
        solve_fn=solve_fn, progress=args.progress,
    )
    _emit({
        "problem": data.name,
        "scenarios": int(X0.shape[0]),
        "chunks": out.chunks_done,
        "wall_s": round(out.wall_s, 3),
        "solves_per_sec_wall": round(X0.shape[0] / max(out.wall_s, 1e-9), 1),
        "residual_max": float(out.residual.max()),
        "converged_all": bool(out.converged.all()),
        "checkpoint": str(args.checkpoint) if args.checkpoint else None,
    })
    if args.out:
        np.savez(args.out, U=out.U, residual=out.residual,
                 iterations=out.iterations, converged=out.converged)
        _emit({"results": args.out})
    return 0


def cmd_export(args) -> int:
    """Write a reference-format dataset file (``input_%d.txt`` layout),
    or with ``--aot`` a serialized AOT-compiled solver artifact."""
    import tpu_gpad
    from tpu_gpad.io import SolverDataset, write_solver_dataset
    from tpu_gpad.schedule import momentum_schedule

    problem = _build_problem(args)
    if args.aot:
        from tpu_gpad.aot import export_solver
        from tpu_gpad.solver import SolverConfig

        data = tpu_gpad.dualize(
            tpu_gpad.condense(problem), iterations=args.iterations,
            paired="auto",
        )
        blob = export_solver(
            data, SolverConfig(iterations=args.iterations),
            batch_size=args.aot_batch, path=args.out,
        )
        _emit({"artifact": args.out, "bytes": len(blob),
               "batch": args.aot_batch or "symbolic",
               "n_x": data.n_x, "n_u": data.n_u})
        return 0
    qp = tpu_gpad.condense(problem)
    data = tpu_gpad.dualize(qp, iterations=args.iterations)  # dense layout
    x0 = _scenarios(args, problem.n_x)[0]
    g_P = x0 @ np.asarray(data.gP_map) + np.asarray(data.gP_const)
    p_D = x0 @ np.asarray(data.pD_map) + np.asarray(data.pD_const)
    theta, beta = momentum_schedule(args.iterations)
    ds = SolverDataset(
        n_u=problem.n_u, N=problem.horizon, m=data.m,
        num_iterations=args.iterations, L=float(np.asarray(data.L)),
        M_G=np.asarray(data.MG_T).T, g_P=g_P,
        G_L=np.asarray(data.GL_T).T, p_D=p_D,
        theta=theta, beta=beta,
    )
    write_solver_dataset(args.out, ds)
    _emit({"dataset": args.out, "n_u": ds.n_u, "N": ds.N, "m": ds.m,
           "iterations": ds.num_iterations, "x0": x0.tolist()})
    return 0


def cmd_info(args) -> int:
    import jax

    import tpu_gpad

    from tpu_gpad.solver.core import resolve_engine, resolve_flat, resolve_form
    from tpu_gpad.utils import solve_flops

    problem = _build_problem(args)
    if getattr(args, "engine", "auto") == "stagewise":
        from tpu_gpad.stagewise import (
            build_stagewise, condensed_operand_mb, stagewise_compatible)

        ok, reason = stagewise_compatible(problem)
        if not ok:
            raise SystemExit(f"--engine stagewise: {reason}")
        sw = build_stagewise(problem, iterations=args.iterations)
        _emit({
            "problem": problem.name,
            "n_x": problem.n_x, "n_u": problem.n_u,
            "horizon": problem.horizon,
            "engine": "stagewise", "m": sw.m, "L": float(np.asarray(sw.L)),
            "stagewise_data_mb": round(sum(
                np.asarray(getattr(sw, f.name)).nbytes
                for f in __import__("dataclasses").fields(sw)
                if hasattr(getattr(sw, f.name), "nbytes")) / 1e6, 4),
            "condensed_operand_mb": round(condensed_operand_mb(problem), 4),
            "devices": [str(d) for d in jax.devices()],
        })
        return 0
    qp = tpu_gpad.condense(problem)
    data = tpu_gpad.dualize(qp, iterations=args.iterations, paired=_paired(args))
    cfg = _solver_config(args)
    form = resolve_form(data, cfg)
    flat = form == "mvp" and data.paired and resolve_flat(data, cfg)
    info = {
        "problem": problem.name,
        "n_x": problem.n_x, "n_u": problem.n_u, "horizon": problem.horizon,
        "n_z": qp.n_z, "m": qp.m,
        "paired": data.paired,
        "n_struct": data.n_struct,
        "L": float(np.asarray(data.L)),
        "resolved_engine": resolve_engine(data, cfg),
        "resolved_form": form + ("+flat" if flat else ""),
        "flops_per_iteration_dense": int(
            3 * qp.m + 2 * qp.n_z * qp.m + 3 * qp.n_z + 2 * qp.n_z * qp.m),
        "flops_per_iteration_resolved": int(
            solve_flops(data, 2, form, flat=flat)
            - solve_flops(data, 1, form, flat=flat)),
        "devices": [str(d) for d in jax.devices()],
    }
    if args.bound:
        from tpu_gpad.bounds import certify

        box = (np.atleast_2d(problem.x_min)[0] if problem.x_min is not None
               else np.full(problem.n_x, -0.4))
        box_hi = (np.atleast_2d(problem.x_max)[0] if problem.x_max is not None
                  else np.full(problem.n_x, 0.4))
        kw = (dict(n_samples=50, seed=args.seed)
              if args.bound_method == "sampled" else {})
        n_nu, dn, L = certify(qp, 0.8 * box, 0.8 * box_hi,
                              eps_g=args.eps_v, eps_V=args.eps_v,
                              method=args.bound_method, **kw)
        info["certified_iterations"] = int(n_nu)
        info["dual_norm_bound"] = float(dn.delta)
    _emit(info)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu_gpad",
        description="Batched GPAD solver for condensed linear-MPC QPs",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("solve", help="solve a batch of MPC QPs")
    _add_problem_args(p)
    _add_solver_args(p)
    p.add_argument("--dataset", help="reference-format dataset file "
                   "(overrides --problem; x0 is baked into the file)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states, one per row")
    p.add_argument("--time", action="store_true",
                   help="measure device time (slope method)")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("closedloop", help="closed-loop MPC simulation")
    _add_problem_args(p)
    _add_solver_args(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states")
    p.add_argument("--warm-start", action="store_true")
    p.add_argument("--plot", help="write SoC/current trajectory plot (png)")
    p.set_defaults(fn=cmd_closedloop)

    p = sub.add_parser("sweep", help="chunked scenario sweep w/ checkpoint")
    _add_problem_args(p)
    _add_solver_args(p)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states")
    p.add_argument("--chunk-size", type=int, default=4096)
    p.add_argument("--sharded", action="store_true",
                   help="spread each chunk over all visible devices "
                        "(shard_map scenario data-parallelism)")
    p.add_argument("--checkpoint", help="npz checkpoint path (resume if exists)")
    p.add_argument("--out", help="write result arrays to this npz")
    p.add_argument("--progress", action="store_true")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser(
        "export",
        help="write reference-format dataset file, or (--aot) a serialized "
             "AOT-compiled solver artifact",
    )
    _add_problem_args(p)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x0", help="text file of initial states (first row used)")
    p.add_argument("--batch", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--out", required=True)
    p.add_argument("--aot", action="store_true",
                   help="write a jax.export StableHLO solver artifact "
                        "(reload with tpu_gpad.aot.load_solver) instead of "
                        "a reference-format text dataset")
    p.add_argument("--aot-batch", type=int, default=None,
                   help="concrete batch size for --aot (default: symbolic "
                        "batch via the XLA engine)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("info", help="problem dims, L, flops, devices")
    _add_problem_args(p)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "pallas", "stagewise"],
                   help="report the condensed routing (auto/xla/pallas) "
                        "or the stage-wise engine's data/L instead")
    p.add_argument("--paired", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--bound", action="store_true",
                   help="compute the certified iteration bound")
    p.add_argument("--bound-method", default="sampled",
                   choices=["sampled", "milp"],
                   help="Delta bound: vertex/sampling, or the paper's "
                        "exact eq.-(16) MILP")
    p.add_argument("--eps-v", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=1, help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

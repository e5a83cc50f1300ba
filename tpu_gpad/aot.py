"""AOT solver export: serialized StableHLO artifacts for serving.

The reference ships a prebuilt solver binary (`build/main`, SURVEY.md C10)
compiled for one GPU architecture. The JAX analogue is ``jax.export``:
trace + lower the jitted solve once, serialize the StableHLO (with the
problem constants baked in), and reload it later — in a process that
never imports ``tpu_gpad`` or re-traces anything — via ``load_solver``. One artifact = one deployed controller.

Two batch conventions:

- ``batch_size=None`` (default): the batch dimension is exported
  SYMBOLIC (any batch size at call time).
- ``batch_size=B``: concrete shapes, serving that one batch size only.

Either way the artifact runs the XLA engine: ``jax.export`` gives no
compatibility guarantee for the fused Triton kernel's custom call and
refuses to serialize it.

The exported callable returns the ``SolveResult`` fields as a plain dict
(pytree-serialization-friendly).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp

from tpu_gpad.types import GPADData
from tpu_gpad.solver.core import SolverConfig, solve_batch


def export_solver(
    data: GPADData,
    config: SolverConfig = SolverConfig(),
    batch_size: int | None = None,
    path: str | Path | None = None,
) -> bytes:
    """Serialize an AOT-compiled batched solve for this problem.

    The returned bytes (also written to ``path`` if given) reload with
    :func:`load_solver` on a machine with the same accelerator platform.
    All problem constants (``GPADData``) are baked into the artifact; the
    only runtime input is ``x0`` of shape (B, n_x) float32.
    """
    from jax import export as jexport

    config = dataclasses.replace(config, engine="xla")
    if batch_size is None:
        (b,) = jexport.symbolic_shape("b")
        x_spec = jax.ShapeDtypeStruct((b, data.n_x), jnp.float32)
    else:
        x_spec = jax.ShapeDtypeStruct((batch_size, data.n_x), jnp.float32)

    def fn(x0):
        res = solve_batch(data, x0, config=config)
        return {
            "u": res.u,
            "z": res.z,
            "y": res.y,
            "iterations": res.iterations,
            "residual": res.residual,
            "gap": res.gap,
            "converged": res.converged,
        }

    exported = jexport.export(jax.jit(fn))(x_spec)
    blob = exported.serialize()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def load_solver(src: bytes | str | Path):
    """Deserialize an :func:`export_solver` artifact into a callable.

    Returns ``solve(x0) -> dict`` with the ``SolveResult`` fields. Needs
    only jax at load time (no tpu_gpad imports, no re-trace, no
    re-compile beyond XLA consuming the shipped StableHLO)."""
    from jax import export as jexport

    if not isinstance(src, (bytes, bytearray)):
        src = Path(src).read_bytes()
    exported = jexport.deserialize(bytes(src))

    def solve(x0):
        return exported.call(jnp.asarray(x0, dtype=jnp.float32))

    return solve


def export_stagewise_solver(
    data,
    config: SolverConfig = SolverConfig(),
    batch_size: int | None = None,
    path: str | Path | None = None,
) -> bytes:
    """:func:`export_solver` for the STAGE-WISE engine: one deployable
    long-horizon controller artifact with the O(N) Riccati constants
    baked in (``StagewiseData`` from ``build_stagewise``).

    Same two batch conventions: symbolic batch pins the sequential sweeps
    (the scan routing rule needs a concrete B); a concrete ``batch_size``
    resolves routing exactly as a live ``solve_stagewise`` would."""
    from jax import export as jexport

    from tpu_gpad.stagewise import solve_stagewise

    scan = "auto"
    if batch_size is None:
        # symbolic batch: no branch on B is possible, so pin the
        # sequential sweeps (the associative rule needs a concrete B)
        scan = "sequential"
        (b,) = jexport.symbolic_shape("b")
        x_spec = jax.ShapeDtypeStruct((b, data.n_x), jnp.float32)
    else:
        x_spec = jax.ShapeDtypeStruct((batch_size, data.n_x), jnp.float32)

    def fn(x0):
        res = solve_stagewise(data, x0, config=config, scan=scan)
        return {
            "u": res.u,
            "z": res.z,
            "y": res.y,
            "iterations": res.iterations,
            "residual": res.residual,
            "gap": res.gap,
            "converged": res.converged,
        }

    exported = jexport.export(jax.jit(fn))(x_spec)
    blob = exported.serialize()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob

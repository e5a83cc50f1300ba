"""Multi-plant solving: a stack of DIFFERENT QPs in one device call.

The reference solves its 28 ``inputs_manysets`` datasets one file at a time
in a host loop (``main.cu:104-108`` re-reads and re-uploads per dataset).
Here the per-plant constants stack along a leading axis and ``vmap``
runs the whole solver over it: every plant's iteration runs in the same
XLA program, so the device sees one batched matmul per step
instead of P sequential launches — fleets of heterogeneous controllers
(same dimensions, different dynamics/costs/limits) solve together.

Requirements: all plants share the condensed dimensions (n_z, m, layout,
schedule length). Dynamics, costs, constraint data, and Lipschitz
constants may all differ — they live in the stacked operands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from tpu_gpad.types import GPADData, SolveResult
from tpu_gpad.solver.core import SolverConfig, solve_batch

_META = ("n_u", "n_x", "horizon", "paired", "n_struct")
_ARRAYS = (
    "MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const", "L",
    "theta", "beta",
)


def stack_data(datas: Sequence[GPADData]) -> GPADData:
    """Stack per-plant ``GPADData`` along a new leading plant axis.

    All plants must agree on every static field and every array shape
    (``dualize`` them with the same ``iterations``). The result is a
    normal ``GPADData`` pytree whose array leaves carry a leading
    ``(n_plants,)`` axis — consumed by :func:`solve_multi`, not by
    ``solve_batch`` directly.
    """
    if len(datas) == 0:
        raise ValueError("stack_data needs at least one GPADData")
    d0 = datas[0]
    for i, d in enumerate(datas[1:], start=1):
        for f in _META:
            if getattr(d, f) != getattr(d0, f):
                raise ValueError(
                    f"plant {i} differs in {f}: "
                    f"{getattr(d, f)!r} != {getattr(d0, f)!r}"
                )
        for f in _ARRAYS:
            if getattr(d, f).shape != getattr(d0, f).shape:
                raise ValueError(
                    f"plant {i} differs in {f} shape: "
                    f"{getattr(d, f).shape} != {getattr(d0, f).shape}"
                )
        if (d.D is None) != (d0.D is None):
            raise ValueError(
                f"plant {i} mixes paired layouts with/without the dual "
                "Hessian D; re-dualize consistently"
            )
        if (d.soft_damp is None) != (d0.soft_damp is None):
            raise ValueError(
                f"plant {i} mixes soft and hard constraint stacks; "
                "re-dualize consistently"
            )
    stacked = {
        f: jnp.stack([getattr(d, f) for d in datas]) for f in _ARRAYS
    }
    stacked["D"] = (
        None if d0.D is None else jnp.stack([d.D for d in datas])
    )
    stacked["soft_damp"] = (
        None if d0.soft_damp is None
        else jnp.stack([d.soft_damp for d in datas])
    )
    return dataclasses.replace(
        d0, name=f"stack[{','.join(d.name for d in datas)}]", **stacked
    )


def solve_multi(
    data: GPADData | Sequence[GPADData],
    x0: jax.Array,
    config: SolverConfig = SolverConfig(),
    y0: Optional[jax.Array] = None,
) -> SolveResult:
    """Solve ``P`` different QPs, each over its own scenario batch, at once.

    ``data``: a :func:`stack_data` result (or a sequence, stacked here).
    ``x0``: shape (P, ..., n_x) — per-plant scenario batches (the plant
    axis first, then any batch dims). ``y0``: optional warm start with
    the same leading plant axis. Returns a ``SolveResult`` whose leaves
    carry the (P, ...) leading axes.

    Engine/form selection runs per-plant slice inside the vmap, so the
    same routing rules apply as for ``solve_batch``; the fused Pallas
    kernels batch over plants via the vmap grid axis where available.
    """
    if not isinstance(data, GPADData):
        data = stack_data(list(data))
    n_plants = data.theta.shape[0]
    if x0.shape[0] != n_plants:
        raise ValueError(
            f"x0 leading axis {x0.shape[0]} != number of plants {n_plants}"
        )

    def one(d, x, y):
        return solve_batch(d, x, config=config, y0=y)

    in_axes = (0, 0, None if y0 is None else 0)
    return jax.vmap(one, in_axes=in_axes)(data, x0, y0)

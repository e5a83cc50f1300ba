"""Online GPAD solvers.

- ``reference``: pure-NumPy oracle (functional replacement for the
  reference's ``seq_functions.cpp`` CPU baseline and ``acceldualgrad.m``).
- ``core``: jitted JAX solver — fixed-iteration and epsilon-termination
  modes, natively batched over scenarios.
- ``kernels``: fused Pallas (Triton) GPU kernel running the whole
  fixed-iteration dual loop in one launch.
"""

from tpu_gpad.solver.core import (
    solve,
    solve_batch,
    solve_to_accuracy,
    SolverConfig,
)
from tpu_gpad.solver.multi import solve_multi, stack_data

__all__ = [
    "solve",
    "solve_batch",
    "solve_multi",
    "solve_to_accuracy",
    "stack_data",
    "SolverConfig",
]

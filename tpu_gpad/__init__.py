"""tpu_gpad: a batched GPAD engine for embedded linear MPC on the GPU.

Implements the accelerated dual gradient-projection (GPAD) algorithm of
Patrinos & Bemporad for condensed linear-MPC QPs in JAX:

- offline condensation of LTI plant models into the dual-QP constants
  (``M_G, g_P, G_L, p_D, L`` and the theta/beta momentum schedules),
- a jitted GPAD iteration with both fixed-iteration (hard real-time) and
  epsilon-optimality termination modes,
- scenario batching that turns the hot matrix-vector products into
  matmuls, with a fused Pallas (Triton) kernel that keeps the dual loop's
  state in registers on the GPU,
- the paper's O(N) non-condensed (stage-wise) engine for long horizons —
  Riccati-precomputed LQR oracle behind two executors (parallel-prefix
  and sequential scans), with estimation (MHE), differentiation, robust
  scenario stacks and multi-plant batching riding it past the
  condensation wall,
- shard_map scaling of the scenario batch across device meshes with
  psum-collective convergence tests.

Reference behavior spec: shreyasren/GPU-DualGradient-MPC
(``Code/MATLAB/acceldualgrad.m``, ``Code/CUDA/FinalProject/``).
"""

from tpu_gpad.types import LinearMPCProblem, CondensedQP, GPADData, SolveResult
from tpu_gpad.condense import condense, dualize
from tpu_gpad.schedule import momentum_schedule
from tpu_gpad import problems, io
from tpu_gpad.solver import solve, solve_batch, solve_to_accuracy
from tpu_gpad.solver.qp import polish, polish_batch
from tpu_gpad.closed_loop import Controller, simulate
from tpu_gpad.nonlinear import (
    NMPC,
    RobustNMPC,
    rk4,
    simulate_nonlinear,
    simulate_nonlinear_device,
)
from tpu_gpad.device_condense import dualize_ltv_device
from tpu_gpad.diff import (
    feedback_gain,
    make_data_differentiable_solver,
    make_differentiable_solver,
    sensitivity,
)
from tpu_gpad.robust import (
    lqr_gain,
    scenario_plan,
    scenario_problem_variants,
    scenario_qp,
    tube_tightened_problem,
)
from tpu_gpad.mhe import MovingHorizonEstimator
from tpu_gpad.stagewise import (
    StagewiseData,
    auto_solver,
    StagewiseController,
    build_stagewise,
    solve_stagewise,
    solve_stagewise_jit,
    solve_stagewise_multi,
    stack_stagewise,
    stagewise_compatible,
    stagewise_preferred,
)
from tpu_gpad.estimator import (
    ExtendedKalmanFilter,
    KalmanFilter,
    OffsetFreeController,
    TargetCalculator,
    kalman_gain,
)

__version__ = "0.7.0"

__all__ = [
    "LinearMPCProblem",
    "CondensedQP",
    "GPADData",
    "SolveResult",
    "condense",
    "dualize",
    "momentum_schedule",
    "problems",
    "io",
    "solve",
    "solve_batch",
    "solve_to_accuracy",
    "Controller",
    "simulate",
    "NMPC",
    "RobustNMPC",
    "rk4",
    "simulate_nonlinear",
    "simulate_nonlinear_device",
    "dualize_ltv_device",
    "feedback_gain",
    "make_data_differentiable_solver",
    "make_differentiable_solver",
    "sensitivity",
    "scenario_qp",
    "scenario_plan",
    "scenario_problem_variants",
    "tube_tightened_problem",
    "lqr_gain",
    "polish",
    "polish_batch",
    "ExtendedKalmanFilter",
    "KalmanFilter",
    "MovingHorizonEstimator",
    "StagewiseData",
    "auto_solver",
    "StagewiseController",
    "build_stagewise",
    "solve_stagewise",
    "solve_stagewise_jit",
    "solve_stagewise_multi",
    "stack_stagewise",
    "stagewise_compatible",
    "stagewise_preferred",
    "OffsetFreeController",
    "TargetCalculator",
    "kalman_gain",
]

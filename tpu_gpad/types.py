"""Core datatypes.

The data model splits the pipeline into three stages, mirroring the layer map
of the reference (SURVEY.md section 1):

  LinearMPCProblem  --condense-->  CondensedQP  --dualize-->  GPADData

``GPADData`` is a JAX pytree holding everything the online solver needs; all
state-dependent quantities (``g_P(x0)``, ``p_D(x0)``) are stored as affine
maps of the parameter ``x0`` so that a batch of scenarios only differs by two
cheap matmuls (reference recomputes these per solve on the host:
``Code/MATLAB/gpad.m:81-85``, ``acceldualgrad.m:20-23``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import jax
import numpy as np


@dataclass(frozen=True)
class LinearMPCProblem:
    """A discrete-time LTI MPC problem (the L0 modeling layer).

    Dynamics ``x_{k+1} = A x_k + B u_k``; stage cost
    ``x_k' Q x_k + u_k' R u_k`` over a horizon of ``N`` steps; box constraints
    on states (``x_min <= x_k <= x_max`` for k = 1..N) and inputs
    (``u_min <= u_k <= u_max`` for k = 0..N-1); optional per-stage input
    coupling ``K_u u_k = 0`` encoded as two inequalities (the battery problem's
    charge-conservation constraint, ``Code/MATLAB/gpad.m:44,65-73,84-85``).

    Linear TIME-VARYING dynamics (``x_{k+1} = A_k x_k + B_k u_k``, e.g. a
    successive linearization of a nonlinear plant along a trajectory) are
    expressed by passing stacked ``A`` of shape (N, n_x, n_x) and ``B`` of
    shape (N, n_x, n_u) — ``is_ltv`` is then True, condensation uses the
    per-stage transition products, and everything downstream of the
    condensed QP (dualize, engines, Controller) is unchanged.
    ``closed_loop.simulate`` and ``dare_terminal_weight`` require LTI.
    """

    A: np.ndarray  # (n_x, n_x), or (N, n_x, n_x) for LTV
    B: np.ndarray  # (n_x, n_u), or (N, n_x, n_u) for LTV
    Q: np.ndarray  # (n_x, n_x) stage state cost, or (N, n_x, n_x) per stage
    R: np.ndarray  # (n_u, n_u) stage input cost, or (N, n_u, n_u) per stage
    horizon: int  # N, number of prediction steps
    x_min: Optional[np.ndarray] = None  # (n_x,), or (N, n_x) per-stage
    # bounds (stages 1..N; e.g. tube-MPC constraint tightening), or None
    x_max: Optional[np.ndarray] = None
    Q_terminal: Optional[np.ndarray] = None  # (n_x, n_x) terminal state
    # weight replacing Q at stage N (e.g. the DARE solution via
    # condense.dare_terminal_weight for LQR-consistent closed loops);
    # None means the stage cost Q is used at every stage (the reference's
    # formulation, gpad.m:76)
    u_min: Optional[np.ndarray] = None  # (n_u,) or (N, n_u) per stage (0..N-1)
    u_max: Optional[np.ndarray] = None
    K_u: Optional[np.ndarray] = None  # (n_c, n_u) per-stage coupling, K_u u_k = 0
    du_min: Optional[np.ndarray] = None  # (n_u,) input rate (slew) limits:
    du_max: Optional[np.ndarray] = None  # du_min <= u_k - u_{k-1} <= du_max
    # for k = 0..N-1, with u_{-1} = the previously APPLIED move, which
    # becomes part of the QP parameter p = [x0; ...; u_prev] (see condense).
    # Standard production-MPC actuator slew protection; the reference has
    # amplitude boxes only (gpad.m:84-85).
    H_x: Optional[np.ndarray] = None  # (q_x, n_x) general state polytope:
    h_x: Optional[np.ndarray] = None  # H_x x_k <= h_x for k = 1..N, with
    # h_x of shape (q_x,) or per-stage (N, q_x). Beyond the reference's
    # boxes — e.g. coupled SoC budgets or velocity-dependent limits. Rows
    # are one-sided, so problems using them condense to the DENSE dual
    # layout (no [P; -P] pairing) unless each row's negation also appears.
    H_u: Optional[np.ndarray] = None  # (q_u, n_u) general input polytope:
    h_u: Optional[np.ndarray] = None  # H_u u_k <= h_u for k = 0..N-1,
    # h_u of shape (q_u,) or (N, q_u). Generalizes K_u (which emits the
    # +/- pair for equality couplings).
    c: Optional[np.ndarray] = None  # (n_x,) or (N, n_x) KNOWN per-stage
    # affine dynamics offset: x_{k+1} = A_k x_k + B_k u_k + c_k. Folded
    # into the condensed QP's constants (b0, g) at condense time — this is
    # the linearization residual of successive-linearization NMPC
    # (tpu_gpad.nonlinear), fixed per QP, unlike the process_disturbance
    # PARAMETER which varies per solve.
    name: str = "lti"

    @property
    def n_x(self) -> int:
        return self.A.shape[-1]

    @property
    def n_u(self) -> int:
        return self.B.shape[-1]

    @property
    def n_z(self) -> int:
        return self.n_u * self.horizon

    @property
    def is_ltv(self) -> bool:
        """True when A/B are stacked per-stage (time-varying dynamics)."""
        return np.ndim(self.A) == 3


@dataclass(frozen=True)
class CondensedQP:
    """The condensed primal QP (reference: ``gpad.m:76-85``).

    minimize   0.5 z' H z + (F' x0 + g)' z
    subject to G z <= b0 + E x0

    with ``z = [u_0; ...; u_{N-1}]``. ``F`` maps the parameter into the linear
    cost (``f = x0' F`` in ``gpad.m:81``), ``E`` maps it into the constraint
    right-hand side (``b_i = b0 + E x0``, cf. ``gpad.m:85`` where only the
    state-box rows depend on x0).
    """

    H: np.ndarray  # (n_z, n_z) SPD
    F: np.ndarray  # (n_x, n_z)
    g: np.ndarray  # (n_z,) constant linear-cost term (zero for the bundled problems)
    G: np.ndarray  # (m, n_z)
    b0: np.ndarray  # (m,)
    E: np.ndarray  # (m, n_x)
    n_u: int
    n_x: int
    horizon: int
    name: str = "qp"

    @property
    def n_z(self) -> int:
        return self.H.shape[0]

    @property
    def m(self) -> int:
        return self.G.shape[0]


# RHS sentinel for INERT dual rows (a vacuous bound so the projected dual
# stays exactly 0 every iteration): finite (not inf) so residual/gap
# recovery (L * (q + p_D), w * gz) stays NaN-free. Used by the TP row
# padding (parallel.pad_dual_rows) and by one-sided polytope rows on the
# device-condensation path (their paired minus side never exists).
PAD_BIG = 1e20


def _register_pytree_dataclass(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@dataclass(frozen=True)
class GPADData:
    """Everything the online GPAD solver needs, laid out for batched matmuls.

    The per-iteration math (reference: ``acceldualgrad.m:43-52``; cookbook
    steps 1-4) in canonical (MATLAB/paper) sign convention is

        w    = y + beta_k (y - y_prev)
        zhat = -(w @ MG_T) - g_P            # MG_T = (H^-1 G')' = G H^-1
        z    = (1 - theta_k) z + theta_k zhat
        y+   = relu(w + zhat @ GL_T + p_D)  # GL_T = (G / L)'

    where for a batch of scenarios ``X0`` of shape (B, n_x):

        g_P = X0 @ gP_map + gP_const        # = H^-1 (F' x0 + g)
        p_D = X0 @ pD_map + pD_const        # = -(b0 + E x0) / L

    Both hot products are (B, m) @ (m, n_z) and (B, n_z) @ (n_z, m) matrix
    multiplies — the batched replacement for the reference's
    one-row-per-CUDA-thread MVP kernels
    (``kernel_functions.cu:16-64,142-200``).
    """

    MG_T: jax.Array  # (m, n_z)  == (H^-1 G')' ; step-2 operand
    GL_T: jax.Array  # (n_z, m)  == (G/L)'     ; step-4 operand
    gP_map: jax.Array  # (n_x, n_z)
    gP_const: jax.Array  # (n_z,)
    pD_map: jax.Array  # (n_x, m)
    pD_const: jax.Array  # (m,)
    # --- paired (half-stack) layout -------------------------------------
    # MPC box/coupling constraint stacks pair every row with its negation
    # (gpad.m:84-85 builds [S; -S; I; -I; K; -K]). When ``paired`` is True
    # the operands are stored for the half stack P (m_h = m/2 rows):
    # ``MG_T`` is (m_h, n_z), ``GL_T`` is (n_z, m_h), and all dual-sized
    # vectors use shape (..., 2, m_h) with index 0 = +P rows, 1 = -P rows.
    # Step 2 contracts (w[+] - w[-]) against the half stack and step 4
    # computes one product and applies it with both signs — HALF the flops
    # and half the constraint-matrix memory of the dense layout the
    # reference uses (kernel_functions.cu treats G as fully dense).
    L: jax.Array  # () Lipschitz constant used for the 1/L scaling
    theta: jax.Array  # (max_iters,) momentum schedule
    beta: jax.Array  # (max_iters,)
    soft_damp: Optional[jax.Array] = None  # (m_h,) per-row dual damping
    # for SOFT (quadratic-penalty) constraints, the slack-free
    # formulation: a constraint softened with penalty weight rho
    # contributes -(1/2 rho)||y_row||^2 to the dual, so its projected-
    # gradient update becomes y+ = relu((1 - damp) * w + <usual step>)
    # with damp = (1/rho)/L on soft rows and 0 elsewhere, and L includes
    # the +1/rho Hessian shift. Equivalent to the host slack formulation
    # (condense soft_state=rho: same optimum, s* = y*/rho) without the
    # 2 N n_x extra decision variables. Paired layouts store the
    # half-stack (m_h,) vector (both +/- sides of a soft box row are
    # soft); None means no soft rows (the usual case).
    D: Optional[jax.Array] = None  # (m_h, m_h) scaled dual Hessian
    # = P H^-1 P' / L, precomputed for the dual-only iteration form: steps
    # 2+4 collapse into q = -(w+ - w-) @ D - e with e = g_P @ GL_T per
    # scenario, and the primal z is recovered AFTER the loop from the
    # accumulated s = sum_k c_k (w+ - w-)_k via one matmul. One square
    # matmul per iteration instead of two rectangular ones; z/zhat never
    # touched in the hot loop. (Pure algebra on acceldualgrad.m:43-52 — no
    # reference analogue; the CUDA code runs all four steps explicitly every
    # iteration, main.cu:160-175.)
    # static metadata
    n_u: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_x: int = dataclasses.field(metadata=dict(static=True), default=0)
    horizon: int = dataclasses.field(metadata=dict(static=True), default=0)
    name: str = dataclasses.field(metadata=dict(static=True), default="gpad")
    paired: bool = dataclasses.field(metadata=dict(static=True), default=False)
    n_struct: Optional[int] = dataclasses.field(
        metadata=dict(static=True), default=None
    )
    # When set (paired "flat" layout, condense._flat_reorder): half-stack
    # rows [n_struct:] are EXACTLY the identity I_{n_z} in column order
    # (the input-box block, reference kernel_functions.cu:74-109's flat
    # variants). Consequences the solver may exploit: GL_T[:, n_struct:]
    # == I/L (step-4 box columns need no matmul) and MG_T[n_struct:] ==
    # H^-1 rows. None when undetected; the dense algebra remains valid
    # regardless — n_struct is an optimization hint, not a layout change.

    @property
    def n_z(self) -> int:
        return self.MG_T.shape[1]

    @property
    def m(self) -> int:
        """Total number of inequality constraints."""
        return self.MG_T.shape[0] * (2 if self.paired else 1)

    @property
    def m_half(self) -> int:
        if not self.paired:
            raise ValueError("m_half only exists for paired layouts")
        return self.MG_T.shape[0]

    @property
    def max_iters(self) -> int:
        return self.theta.shape[0]


_register_pytree_dataclass(
    GPADData,
    data_fields=(
        "MG_T",
        "GL_T",
        "gP_map",
        "gP_const",
        "pD_map",
        "pD_const",
        "soft_damp",
        "D",
        "L",
        "theta",
        "beta",
    ),
    meta_fields=("n_u", "n_x", "horizon", "name", "paired", "n_struct"),
)


@dataclass(frozen=True)
class SolveResult:
    """Output of a GPAD solve.

    ``u`` is the first control move (primal recovery ``u* = z[:n_u]``,
    reference ``acceldualgrad.m:83``); ``z`` the full primal trajectory
    estimate; ``y`` the dual iterate; ``iterations`` the per-scenario
    iteration count at exit (== the fixed budget in fixed mode);
    ``residual`` the final primal infeasibility max(G z - b, 0) max-norm;
    ``gap`` the final dual-gap surrogate (-w' g(zhat)); ``converged`` whether
    the epsilon test passed (always True in fixed-iteration mode).
    Leading batch dims mirror the input batch.
    """

    u: jax.Array
    z: jax.Array
    y: jax.Array
    iterations: jax.Array
    residual: jax.Array
    gap: jax.Array
    converged: jax.Array


_register_pytree_dataclass(
    SolveResult,
    data_fields=("u", "z", "y", "iterations", "residual", "gap", "converged"),
    meta_fields=(),
)

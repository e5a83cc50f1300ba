"""Closed-loop MPC simulation (the reference's controller loop).

Reference: ``Code/MATLAB/gpad.m:79-95`` runs 1000 samples of
solve -> apply first move -> propagate state, re-condensing the constraint
RHS from x0 every sample and recomputing ``inv(H)`` inside every solve
(``acceldualgrad.m:20-23`` — an O(n_z^3) per-solve cost this design removes:
condensation happens once offline and the x0-dependence is an affine map).

Design: the entire closed loop — all T samples, each containing a
full GPAD solve — is ONE jitted ``lax.scan``. Nothing crosses the host
boundary until the final trajectory is fetched; the reference crosses it
twice per sample (H2D of b_i, D2H of u*, ``main.cu:136-180``). The loop also
runs *batched*: B independent plants (different initial SoCs) are simulated
in lockstep, which is how the scenario-sweep benchmarks of BASELINE.json
config 5 are produced.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from tpu_gpad.types import LinearMPCProblem, GPADData
from tpu_gpad.condense import condense, dualize
from tpu_gpad.solver.core import SolverConfig, solve_batch


@dataclass(frozen=True)
class ClosedLoopResult:
    """Trajectories of a closed-loop run.

    ``X``: (T+1, B, n_x) states (X[0] = x0); ``U``: (T, B, n_u) applied first
    moves; ``residual``/``iterations``: (T, B) per-sample solver diagnostics.
    For unbatched runs B == 1.
    """

    X: jax.Array
    U: jax.Array
    residual: jax.Array
    iterations: jax.Array


jax.tree_util.register_dataclass(
    ClosedLoopResult,
    data_fields=["X", "U", "residual", "iterations"],
    meta_fields=[],
)


@functools.partial(jax.jit, static_argnames=("n_steps", "config", "warm_start"))
def _simulate_jit(
    data: GPADData,
    A: jax.Array,
    B: jax.Array,
    X0: jax.Array,
    n_steps: int,
    config: SolverConfig,
    warm_start: bool,
    X_ref: jax.Array | None = None,
    U_prev0: jax.Array | None = None,
    R_traj: jax.Array | None = None,
) -> ClosedLoopResult:
    batch = X0.shape[0]
    dual_shape = (
        (batch, 2, data.m_half) if data.paired else (batch, data.m)
    )
    y_init = jnp.zeros(dual_shape, dtype=jnp.float32)

    def step(carry, t):
        x, y_ws, u_prev = carry
        p = x
        if X_ref is not None:
            p = jnp.concatenate([x, X_ref], axis=-1)
        elif R_traj is not None:
            # preview: sample t sees references for stages 1..N, i.e. the
            # window R_traj[t+1 : t+N+1], shared across the batch
            win = jax.lax.dynamic_slice_in_dim(
                R_traj, t + 1, data.horizon, axis=0
            ).reshape(-1)
            p = jnp.concatenate(
                [x, jnp.broadcast_to(win, (batch, win.shape[0]))], axis=-1
            )
        if u_prev is not None:
            # rate-limited problem: the previously applied move is part of
            # the QP parameter p = [x0; r?; u_prev]
            p = jnp.concatenate([p, u_prev], axis=-1)
        res = solve_batch(
            data, p, config=config, y0=y_ws if warm_start else None
        )
        u = res.u
        x_next = x @ A.T + u @ B.T  # plant propagation (gpad.m:93)
        u_next = u if u_prev is not None else None
        return (x_next, res.y, u_next), (x, u, res.residual, res.iterations)

    (x_final, _, _), (Xs, Us, Rs, Its) = jax.lax.scan(
        step, (X0, y_init, U_prev0), jnp.arange(n_steps)
    )
    X = jnp.concatenate([Xs, x_final[None]], axis=0)
    return ClosedLoopResult(X=X, U=Us, residual=Rs, iterations=Its)


def simulate(
    problem: LinearMPCProblem,
    x0: np.ndarray | jax.Array,
    n_steps: int = 1000,
    config: SolverConfig = SolverConfig(),
    data: GPADData | None = None,
    iterations: int = 100,
    warm_start: bool = False,
    paired: bool | str = "auto",
    x_ref: np.ndarray | jax.Array | None = None,
    u_prev0: np.ndarray | jax.Array | None = None,
    preview: bool = False,
) -> ClosedLoopResult:
    """Run the closed loop: condense once, then scan solve->actuate->propagate.

    ``x0`` may be (n_x,) for a single plant or (B, n_x) for a batch of
    scenarios simulated in lockstep. ``warm_start`` seeds each sample's dual
    iterate with the previous sample's solution (consecutive MPC QPs differ
    only in x0, so their duals are close) — the reference cold-starts every
    solve (``acceldualgrad.m:28-33``). ``x_ref`` runs a setpoint-tracking
    loop (condenses with ``tracking=True``; a supplied ``data`` must then
    be tracking-parametrized). With ``preview=True``, ``x_ref`` is instead
    a full reference TRAJECTORY of shape (T_ref, n_x), shared across the
    batch: sample t's solver previews the window ``x_ref[t+1 : t+N+1]``
    (``tracking="preview"`` condensation), holding the final row once the
    trajectory runs out. For rate-limited problems (``du_min``/
    ``du_max`` set) the applied move is threaded back into the next
    sample's parameter; ``u_prev0`` seeds it (default: zeros — actuator
    at rest).
    """
    if preview and x_ref is None:
        raise ValueError("preview=True requires an x_ref trajectory")
    if problem.is_ltv or problem.c is not None:
        raise ValueError(
            "simulate propagates a time-invariant offset-free plant; LTV "
            "or affine-offset problems are for receding-horizon prediction "
            "(Controller / solve_batch / tpu_gpad.nonlinear) — step your "
            "own plant and re-linearize per sample"
        )
    if data is None:
        data = dualize(
            condense(
                problem,
                tracking="preview" if preview else x_ref is not None,
            ),
            iterations=max(iterations, config.iterations or 0),
            paired=paired,
        )
    if config.iterations is None:
        import dataclasses

        config = dataclasses.replace(config, iterations=iterations)
    X0 = jnp.atleast_2d(jnp.asarray(x0, dtype=jnp.float32))
    X_ref = None
    R_traj = None
    if preview:
        R_traj = jnp.asarray(
            pad_reference(x_ref, n_steps + problem.horizon + 1)
        )
    elif x_ref is not None:
        X_ref = jnp.broadcast_to(
            jnp.asarray(x_ref, dtype=jnp.float32), X0.shape
        )
    U_prev0 = None
    if problem.du_max is not None or problem.du_min is not None:
        U_prev0 = jnp.zeros((X0.shape[0], problem.n_u), dtype=jnp.float32)
        if u_prev0 is not None:
            U_prev0 = jnp.broadcast_to(
                jnp.asarray(u_prev0, dtype=jnp.float32), U_prev0.shape
            )
    A = jnp.asarray(problem.A, dtype=jnp.float32)
    B = jnp.asarray(problem.B, dtype=jnp.float32)
    return _simulate_jit(
        data, A, B, X0, n_steps, config, warm_start, X_ref, U_prev0, R_traj
    )


def pad_reference(x_ref, need: int) -> np.ndarray:
    """Hold-last padding of a reference trajectory to ``need`` rows — the
    ONE copy of the receding-window padding arithmetic shared by
    ``simulate``, ``nonlinear.simulate_nonlinear`` and
    ``nonlinear.simulate_nonlinear_device``."""
    R = np.atleast_2d(np.asarray(x_ref, dtype=np.float32))
    if R.shape[0] < need:  # hold the final reference row
        R = np.concatenate(
            [R, np.repeat(R[-1:], need - R.shape[0], axis=0)], axis=0
        )
    return R[:need]


class Controller:
    """Stateful embedded-MPC controller: condense once, then ``step(x) -> u``.

    The serving-side interface the reference implies but never packages:
    ``gpad.m:79-95`` inlines solve -> apply-first-move each sample and
    recondenses per solve. Here condensation/dualization happen once in
    ``__init__`` and each ``step`` is a single jitted solve that
    warm-starts from the previous sample's dual (``warm_start=True``,
    the default — consecutive MPC QPs differ only in x0).

    ``step`` accepts one state (n_x,) or a batch (B, n_x) of independent
    plants and returns the first control move(s) as float32 NumPy. Use
    ``reset()`` on a plant/setpoint discontinuity to drop the warm start.
    """

    def __init__(
        self,
        problem: LinearMPCProblem,
        iterations: int = 100,
        config: SolverConfig | None = None,
        warm_start: bool = True,
        paired: bool | str = "auto",
        data: GPADData | None = None,
        soft_state: float | None = None,
        tracking: bool | str = False,
        input_reference: bool = False,
        process_disturbance: bool = False,
        polish: bool = False,
    ):
        if config is None:
            config = SolverConfig(iterations=iterations)
        if config.iterations is None:
            import dataclasses

            config = dataclasses.replace(config, iterations=iterations)
        if data is not None and (
            soft_state is not None or tracking or input_reference or process_disturbance
        ):
            raise ValueError(
                "pass either a prebuilt `data` or soft_state/tracking, not "
                "both: the controller cannot soften or re-parametrize a QP "
                "that is already dualized"
            )
        if data is not None and polish:
            raise ValueError(
                "polish=True needs the controller's own condensed QP; with "
                "a prebuilt `data` (e.g. move-blocked) the internally "
                "condensed QP would not match the solved one — polish the "
                "results yourself via tpu_gpad.polish with the matching QP"
            )
        self.qp = condense(
            problem,
            soft_state=soft_state,
            tracking=tracking,
            input_reference=input_reference,
            process_disturbance=process_disturbance,
        )
        self.tracking = tracking
        self.preview = tracking == "preview"
        self.input_reference = input_reference
        self.process_disturbance = process_disturbance
        self.rate = problem.du_max is not None or problem.du_min is not None
        if data is None:
            data = dualize(self.qp, iterations=config.iterations, paired=paired)
        self.problem = problem
        self.data = data
        self.config = config
        self.warm_start = warm_start
        self.polish = polish  # refine each step's u* to the exact optimum
        # via a host-side float64 KKT solve on the identified active set
        self._y = None
        self._u_prev = None  # last applied move (rate-limited problems)
        self.last_result = None

    @classmethod
    def from_qp(
        cls,
        qp,
        iterations: int = 100,
        config: SolverConfig | None = None,
        warm_start: bool = True,
        paired: bool | str = "auto",
        tracking: bool | str = False,
        input_reference: bool = False,
        process_disturbance: bool = False,
        rate: bool = False,
        problem: LinearMPCProblem | None = None,
        polish: bool = False,
    ):
        """Serve a PREBUILT ``CondensedQP`` — e.g. a ``scenario_qp`` robust
        stack or any hand-assembled QP of the same parametric class —
        with the full Controller contract (dual warm starts across
        samples, batching, optional active-set polish).

        The flags describe how the QP's PARAMETER is laid out (they must
        match how it was condensed): ``tracking``/``input_reference``/
        ``process_disturbance`` append [r], [u_ref], [d] exactly as in
        ``condense``; ``rate`` appends the previous applied move (no
        ``problem`` needed — dimensions come off the dualized data).
        ``tracking="preview"`` and ``process_disturbance`` DO need
        ``problem`` (e.g. the per-scenario nominal) for the stage/state
        dimensions."""
        if config is None:
            config = SolverConfig(iterations=iterations)
        if config.iterations is None:
            import dataclasses

            config = dataclasses.replace(config, iterations=iterations)
        if problem is None and (tracking == "preview" or process_disturbance):
            raise ValueError(
                "tracking='preview' and process_disturbance need `problem` "
                "for the stage/state dimensions"
            )
        self = cls.__new__(cls)
        self.qp = qp
        self.tracking = tracking
        self.preview = tracking == "preview"
        self.input_reference = input_reference
        self.process_disturbance = process_disturbance
        self.rate = rate
        self.data = dualize(qp, iterations=config.iterations, paired=paired)
        self.problem = problem
        self.config = config
        self.warm_start = warm_start
        self.polish = polish
        self._y = None
        self._u_prev = None
        self.last_result = None
        return self

    def step(self, x, x_ref=None, u_ref=None, d=None) -> np.ndarray:
        """Solve the MPC QP at state ``x`` and return u* (applied move).

        Output shape mirrors the input: (n_u,) for a single (n_x,) state,
        (B, n_u) for a (B, n_x) batch — including B == 1.
        ``x_ref``: the setpoint (same shape as ``x``) for tracking
        controllers (``tracking=True``), or the per-stage reference
        preview of shape (N, n_x) (batched: (B, N, n_x)) for
        ``tracking="preview"`` controllers; defaults to the origin.
        ``u_ref``: the input target (n_u,) (batched: (B, n_u)) for
        ``input_reference=True`` controllers; defaults to zero.
        ``d``: the constant per-stage state offset (n_x,) predicted by the
        internal model (``process_disturbance=True`` controllers, e.g.
        ``Bd @ d_hat`` from an estimator); defaults to zero.
        For rate-limited problems the previous ``step``'s returned move is
        threaded into the parameter automatically (zeros on the first step
        or after ``reset``)."""
        single = np.ndim(x) == 1
        x = np.asarray(x, dtype=np.float32)
        if self.preview:
            N, n_x = self.problem.horizon, self.problem.n_x
            if x_ref is None:
                flat = np.zeros(x.shape[:-1] + (N * n_x,), dtype=np.float32)
            else:
                x_ref = np.asarray(x_ref, dtype=np.float32)
                if x_ref.shape[-2:] != (N, n_x):
                    raise ValueError(
                        f"preview x_ref must end in shape ({N}, {n_x}); "
                        f"got {x_ref.shape}"
                    )
                flat = np.broadcast_to(
                    x_ref.reshape(x_ref.shape[:-2] + (N * n_x,)),
                    x.shape[:-1] + (N * n_x,),
                )
            x = np.concatenate([x, flat], axis=-1)
        elif self.tracking:
            if x_ref is None:
                x_ref = np.zeros_like(x)
            x_ref = np.broadcast_to(
                np.asarray(x_ref, dtype=np.float32), x.shape
            )
            x = np.concatenate([x, x_ref], axis=-1)
        elif x_ref is not None:
            raise ValueError("x_ref requires a tracking controller")
        if self.input_reference:
            n_u = self.data.n_u  # == problem.n_u; valid for from_qp too
            if u_ref is None:
                u_ref = np.zeros(x.shape[:-1] + (n_u,), dtype=np.float32)
            u_ref = np.broadcast_to(
                np.asarray(u_ref, dtype=np.float32), x.shape[:-1] + (n_u,)
            )
            x = np.concatenate([x, u_ref], axis=-1)
        elif u_ref is not None:
            raise ValueError("u_ref requires input_reference=True")
        if self.process_disturbance:
            n_x = self.problem.n_x
            if d is None:
                d = np.zeros(x.shape[:-1] + (n_x,), dtype=np.float32)
            d = np.broadcast_to(
                np.asarray(d, dtype=np.float32), x.shape[:-1] + (n_x,)
            )
            x = np.concatenate([x, d], axis=-1)
        elif d is not None:
            raise ValueError("d requires process_disturbance=True")
        x = jnp.atleast_2d(jnp.asarray(x, dtype=jnp.float32))
        if self.rate:
            u_prev = self._u_prev
            if u_prev is None:
                u_prev = jnp.zeros(
                    (x.shape[0], self.data.n_u), dtype=jnp.float32
                )
            elif u_prev.shape[0] != x.shape[0]:
                # unlike a dropped warm start (benign), resetting u_prev
                # changes the CONSTRAINT semantics: the next move would be
                # slew-limited against an assumed at-rest actuator and the
                # physical rate limit could be violated without any signal.
                # A single stored move broadcasts safely (same actuator
                # state for every scenario); anything else must be stated
                # explicitly via reset(u_prev=...).
                if u_prev.shape[0] == 1:
                    u_prev = jnp.broadcast_to(
                        u_prev, (x.shape[0], self.data.n_u)
                    )
                else:
                    raise ValueError(
                        f"rate-limited controller: batch size changed "
                        f"{u_prev.shape[0]} -> {x.shape[0]} mid-run; the "
                        f"stored previous move is ambiguous. Call "
                        f"reset(u_prev=...) with the actuator state first."
                    )
            x = jnp.concatenate([x, u_prev], axis=-1)
        y0 = self._y if self.warm_start else None
        if y0 is not None and y0.shape[0] != x.shape[0]:
            y0 = None  # batch size changed: warm start no longer applies
        res = solve_batch(self.data, x, config=self.config, y0=y0)
        self._y = res.y
        self.last_result = res
        if self.polish:
            from tpu_gpad.solver.qp import polish_batch

            Z, _ = polish_batch(self.qp, np.asarray(x), np.asarray(res.z))
            u = Z[:, : self.data.n_u].astype(np.float32)
        else:
            u = np.asarray(res.u, dtype=np.float32)
        if self.rate:
            self._u_prev = jnp.asarray(u)
        return u[0] if single else u

    def gain(self, tol: float = 1e-7, ridge: float = 0.0) -> np.ndarray:
        """Local feedback gain du*/dp at the LAST ``step``'s solution.

        The piecewise-affine explicit-MPC gain of the active region the
        last solve landed in (``tpu_gpad.diff.sensitivity``) — p is the
        full QP parameter ([x0] / [x0; r] / ... as configured). Returns
        (n_u, n_p) for a single-plant step or (B, n_u, n_p) batched.
        Requires a prior ``step`` call."""
        if self.last_result is None:
            raise ValueError("gain() needs a prior step() call")
        from tpu_gpad import diff

        K = diff.feedback_gain(self.data, self.last_result, tol=tol,
                               ridge=ridge)
        K = np.asarray(K)
        return K[0] if K.shape[0] == 1 else K

    def reset(self, u_prev=None) -> None:
        """Drop the warm-start state (e.g. after a setpoint change).

        ``u_prev``: for rate-limited problems, the actuator's current
        position to rate-limit the next move against (default: zeros)."""
        self._y = None
        self._u_prev = None
        if u_prev is not None:
            self._u_prev = jnp.atleast_2d(
                jnp.asarray(u_prev, dtype=jnp.float32)
            )


def plot_closed_loop(result: ClosedLoopResult, scenario: int = 0, path: str | None = None):
    """The reference's two trajectory plots (``gpad.m:98-114``): per-cell SoC
    and balancing currents over time. Returns the matplotlib figure, or None
    if matplotlib is unavailable (it is not a hard dependency)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover - matplotlib is present in CI image
        return None

    X = np.asarray(result.X[:, scenario, :])
    U = np.asarray(result.U[:, scenario, :])
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for i in range(X.shape[1]):
        ax0.plot(X[:, i], label=f"cell {i + 1}")
    ax0.set_ylabel("state of charge")
    ax0.legend(loc="best", fontsize=8)
    ax0.set_title("closed-loop SoC trajectories")
    for i in range(U.shape[1]):
        ax1.plot(U[:, i], label=f"cell {i + 1}")
    ax1.set_ylabel("balancing current [A]")
    ax1.set_xlabel("sample")
    ax1.set_title("applied first moves u*")
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
    return fig

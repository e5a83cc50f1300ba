"""Successive-linearization nonlinear MPC (SL-NMPC) on the LTV condenser.

No reference analogue — the reference solver (``Code/MATLAB/gpad.m``,
``Code/CUDA/.../main.cu``) is strictly LTI. This layer turns any
jax-traceable discrete dynamics ``f(x, u) -> x_next`` into a receding-
horizon controller by, per sample:

1. rolling the nominal trajectory from the measured state under the
   previous plan (``lax.scan`` on device),
2. linearizing per stage with ``jax.vmap(jax.jacfwd)`` (device) — giving
   LTV matrices (A_k, B_k) plus the affine residual
   ``c_k = f(xbar_k, ubar_k) - A_k xbar_k - B_k ubar_k`` that makes the
   linear model EXACT at the nominal trajectory,
3. condensing/dualizing the resulting affine-LTV QP (host float64,
   ``condense``/``dualize``) and solving it with the normal GPAD engines
   (device),
4. optionally repeating (SQP-style inner iterations) before applying the
   first move.

The device/host split is deliberate: Jacobians, rollouts and the QP solve
are batched device math; condensation is small dense float64 algebra whose
conditioning matters more than its speed (see ``condense`` module docs).

``device_condense=True`` removes the split entirely: condensation and
dualization run as jitted fp32 device ops (``tpu_gpad.device_condense``),
so one SQP pass — rollout, Jacobians, condense, dualize, GPAD solve — is
ONE device program with no host round-trip. Supports the
box-constrained tracking/preview formulation; rate limits, soft
constraints and polytopes stay on the float64 host path.

``simulate_nonlinear_device`` goes one step further: the ENTIRE closed
loop (re-plan -> apply -> propagate, warm starts threaded) runs as one
``lax.scan`` — one host->device call per trajectory, where the
per-sample device path pays a host round trip several times per sample.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tpu_gpad.condense import condense, dualize
from tpu_gpad.solver import SolverConfig, solve_batch
from tpu_gpad.types import LinearMPCProblem


def rk4(f: Callable, dt: float) -> Callable:
    """Discretize continuous dynamics ``xdot = f(x, u)`` with one classical
    RK4 step of length ``dt`` (zero-order-hold input)."""

    def step(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return step


@partial(jax.jit, static_argnums=0)
def rollout(f: Callable, x0: jax.Array, us: jax.Array) -> jax.Array:
    """Roll ``x_{k+1} = f(x_k, u_k)`` from ``x0`` under the plan ``us``
    of shape (N, n_u). Returns the successor states x_1..x_N, (N, n_x)."""

    def body(x, u):
        xn = f(x, u)
        return xn, xn

    _, xs = jax.lax.scan(body, jnp.asarray(x0), jnp.asarray(us))
    return xs


@partial(jax.jit, static_argnums=0)
def linearize(f: Callable, xs: jax.Array, us: jax.Array):
    """Per-stage linearization of ``f`` along a nominal trajectory.

    ``xs``: (N, n_x) linearization states xbar_0..xbar_{N-1}; ``us``:
    (N, n_u) nominal inputs. Returns ``(A, B, c)`` with shapes
    (N, n_x, n_x), (N, n_x, n_u), (N, n_x) such that the affine model
    ``x_{k+1} = A_k x_k + B_k u_k + c_k`` agrees with ``f`` exactly at
    the nominal (``c_k`` is the linearization residual). All three are
    one vmapped forward-mode Jacobian sweep — device math."""
    xs = jnp.asarray(xs)
    us = jnp.asarray(us)
    A = jax.vmap(jax.jacfwd(f, argnums=0))(xs, us)
    B = jax.vmap(jax.jacfwd(f, argnums=1))(xs, us)
    fx = jax.vmap(f)(xs, us)
    # fp32-highest contractions: the residual c must make the affine model
    # EXACT at the nominal — a reduced-precision default einsum (TF32 on a
    # GPU) would bake a ~1e-3 model error into every linearization
    hp = jax.lax.Precision.HIGHEST
    c = (
        fx
        - jnp.einsum("kij,kj->ki", A, xs, precision=hp)
        - jnp.einsum("kij,kj->ki", B, us, precision=hp)
    )
    return A, B, c


@partial(jax.jit, static_argnames=("config",))
def _nmpc_sw_multi_cold(stacked, X, config):
    from tpu_gpad.stagewise import solve_stagewise_multi

    return solve_stagewise_multi(stacked, X, config=config)


@partial(jax.jit, static_argnames=("config",))
def _nmpc_sw_multi_warm(stacked, X, y0, config):
    from tpu_gpad.stagewise import solve_stagewise_multi

    return solve_stagewise_multi(stacked, X, y0=y0, config=config)


def _nmpc_solve_stagewise_multi(stacked, X, y0, config):
    """Jit-cached multi-plant stage-wise solve for the SQP loop (data as
    pytree args — constant shapes, one trace per closed loop)."""
    if y0 is None:
        return _nmpc_sw_multi_cold(stacked, X, config)
    return _nmpc_sw_multi_warm(stacked, X, y0, config)


class NMPC:
    """Receding-horizon successive-linearization controller.

    ``f``: jax-traceable discrete dynamics ``f(x, u) -> x_next`` (use
    ``rk4(f_cont, dt)`` for continuous models). Cost is the tracking form
    ``sum (x_k - x_ref)' Q (x_k - x_ref) + u_k' R u_k`` (plus
    ``Q_terminal`` at stage N if given); ``x_ref`` is a per-``step``
    argument, so one controller serves moving setpoints.

    ``sqp_iters``: linearize->solve passes per sample. 1 = classic
    real-time-iteration (cheapest, relies on warm starts across samples);
    2-3 tightens the plan when the plant is strongly nonlinear.
    ``damping``: step factor on the plan update between inner passes
    (1.0 = full SQP step; < 1 for fragile linearizations).

    Per-sample cost: one jitted Jacobian sweep + QP solve on device, one
    condense/dualize on host (small dense float64; use
    ``lipschitz="fro_dual"`` to skip the exact eigensolve for larger
    problems). ``plan_batch``/``step_batch`` run B independent scenarios
    with per-scenario linearizations and ONE vmapped device solve
    (``solve_multi``).
    """

    def __init__(
        self,
        f: Callable,
        n_x: int,
        n_u: int,
        horizon: int,
        Q: np.ndarray,
        R: np.ndarray,
        Q_terminal: Optional[np.ndarray] = None,
        x_min: Optional[np.ndarray] = None,
        x_max: Optional[np.ndarray] = None,
        u_min: Optional[np.ndarray] = None,
        u_max: Optional[np.ndarray] = None,
        du_min: Optional[np.ndarray] = None,
        du_max: Optional[np.ndarray] = None,
        H_x: Optional[np.ndarray] = None,
        h_x: Optional[np.ndarray] = None,
        H_u: Optional[np.ndarray] = None,
        h_u: Optional[np.ndarray] = None,
        soft_state: Optional[float] = None,
        iterations: int = 200,
        config: Optional[SolverConfig] = None,
        sqp_iters: int = 1,
        damping: float = 1.0,
        lipschitz: str = "spectral_dual",
        warm_start: bool = True,
        preview: bool = False,
        device_condense: bool = False,
        engine: str = "condensed",
        name: str = "nmpc",
    ):
        if config is None:
            config = SolverConfig(iterations=iterations, restart=True)
        if config.iterations is None:
            import dataclasses

            config = dataclasses.replace(config, iterations=iterations)
        if not 0.0 < damping <= 1.0:
            raise ValueError(f"damping must be in (0, 1]: {damping}")
        if sqp_iters < 1:
            raise ValueError(f"sqp_iters must be >= 1: {sqp_iters}")
        self.f = f
        self.n_x, self.n_u, self.horizon = n_x, n_u, horizon
        self.Q = np.asarray(Q, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.Q_terminal = Q_terminal
        self.bounds = dict(
            x_min=x_min, x_max=x_max, u_min=u_min, u_max=u_max,
            du_min=du_min, du_max=du_max,
            H_x=H_x, h_x=h_x, H_u=H_u, h_u=h_u,
        )
        self.rate = du_min is not None or du_max is not None
        self.soft_state = soft_state
        self.config = config
        self.sqp_iters = sqp_iters
        self.damping = damping
        self.lipschitz = lipschitz
        self.warm_start = warm_start
        self.preview = preview  # per-stage references: x_ref is a
        # (N, n_x) trajectory window instead of one setpoint
        self.name = name
        self._us: np.ndarray | None = None  # previous plan, (N, n_u)
        self._y = None  # previous dual iterate (warm start)
        self._u_prev: np.ndarray | None = None  # last applied move
        self._us_b: np.ndarray | None = None  # batch-mode plan, (B, N, n_u)
        self._y_b = None
        self._u_prev_b: np.ndarray | None = None
        self.last_result = None

        self.engine = engine
        if engine not in ("condensed", "stagewise"):
            raise ValueError(
                f"engine must be 'condensed' or 'stagewise': {engine!r}")
        if engine == "stagewise":
            # the O(N) long-horizon path: per SQP pass, linearize on
            # device, build the stage-wise LQR constants on host (O(N n^3)
            # float64, like _qp_for's condense) and solve with the
            # stage-wise engine. Affine offsets c_k from the
            # linearization and the (fixed-per-plan) reference ride the
            # precomputed dtl/qoff constants (tpu_gpad.stagewise).
            if device_condense:
                raise ValueError(
                    "engine='stagewise' and device_condense are exclusive")
            if soft_state is not None:
                raise ValueError(
                    "engine='stagewise' does not take soft_state (a "
                    "condensation-path feature)")
            if self.rate:
                raise ValueError(
                    "engine='stagewise' does not take rate limits (they "
                    "couple adjacent stages; condensation-path feature)")
        self.device_condense = device_condense
        self._dev_pass = self._dev_pass_batch = None
        if device_condense:
            # the fast path fuses rollout+linearize+condense+dualize+solve
            # into ONE jitted device program per SQP pass (see
            # tpu_gpad.device_condense); unsupported features fall back
            # loudly rather than silently taking the host path
            if u_min is None or u_max is None:
                raise ValueError("device_condense=True needs input boxes")
            if (x_min is None) != (x_max is None):
                raise ValueError(
                    "device_condense=True needs both state bounds or neither"
                )
            if (du_min is None) != (du_max is None):
                raise ValueError(
                    "device_condense=True needs both rate bounds or neither "
                    "(the host path supports one-sided du)"
                )
            if config.mode != "fixed":
                raise ValueError(
                    "device_condense=True supports fixed-iteration mode"
                )
            self._m_h = (
                (n_x * horizon if x_min is not None else 0)
                + (n_u * horizon if self.rate else 0)
                + (np.asarray(H_x).shape[0] * horizon
                   if H_x is not None else 0)
                + (np.asarray(H_u).shape[0] * horizon
                   if H_u is not None else 0)
            )
            # NOTE: polytope rows precede the identity block in
            # dualize_ltv_device's row order — keep _m_h in sync with it
            self._m_h += n_u * horizon
            self._dev_pass, self._dev_pass_batch = self._make_device_pass()

    def _make_device_pass(self):
        """One SQP pass as a single jitted device program (and its vmap).

        rollout -> per-stage Jacobians -> device condensation/dualization
        (``dualize_ltv_device``) -> GPAD solve, with the dual warm start
        threaded through. No host work, no float64 detour — the fully
        device-side real-time iteration."""
        from tpu_gpad.device_condense import dualize_ltv_device

        f, cfg = self.f, self.config
        Q, R, Q_T = self.Q, self.R, self.Q_terminal
        b, preview = self.bounds, self.preview
        N, n_u = self.horizon, self.n_u

        def one_pass(x, us, p, y0):
            xs_next = rollout(f, x, us)
            xs_lin = jnp.concatenate([x[None], xs_next[:-1]], axis=0)
            A, B, c = linearize(f, xs_lin, us)
            data = dualize_ltv_device(
                A, B, c, Q, R, b["u_min"], b["u_max"],
                iterations=cfg.iterations, Q_terminal=Q_T,
                x_min=b["x_min"], x_max=b["x_max"],
                du_min=b["du_min"], du_max=b["du_max"],
                H_x=b["H_x"], h_x=b["h_x"], H_u=b["H_u"], h_u=b["h_u"],
                soft_state=self.soft_state, preview=preview,
                name=self.name,
            )
            res = solve_batch(data, p[None], config=cfg, y0=y0[None])
            us_new = res.z[0, : n_u * N].reshape(N, n_u)
            return us_new, res.y[0], res

        return jax.jit(one_pass), jax.jit(jax.vmap(one_pass))

    def _linearized_problem(self, us: np.ndarray, x: np.ndarray):
        """Linearize along the rollout of ``us`` from ``x`` (the shared
        front half of every SQP pass: condensed, stage-wise and batch)."""
        xs_next = rollout(self.f, jnp.asarray(x, dtype=jnp.float32),
                          jnp.asarray(us, dtype=jnp.float32))
        xs_lin = jnp.concatenate(
            [jnp.asarray(x, dtype=jnp.float32)[None], xs_next[:-1]], axis=0
        )
        A, B, c = linearize(self.f, xs_lin, jnp.asarray(us, dtype=jnp.float32))
        return LinearMPCProblem(
            A=np.asarray(A, dtype=np.float64),
            B=np.asarray(B, dtype=np.float64),
            Q=self.Q,
            R=self.R,
            horizon=self.horizon,
            Q_terminal=self.Q_terminal,
            c=np.asarray(c, dtype=np.float64),
            name=self.name,
            **self.bounds,
        )

    def _qp_for(self, us: np.ndarray, x: np.ndarray):
        """Linearize along the rollout of ``us`` from ``x`` and condense."""
        problem = self._linearized_problem(us, x)
        qp = condense(
            problem,
            tracking="preview" if self.preview else True,
            soft_state=self.soft_state,
        )
        data = dualize(
            qp,
            iterations=self.config.iterations,
            paired="auto",
            lipschitz=self.lipschitz,
        )
        return qp, data

    def plan(self, x, x_ref=None) -> np.ndarray:
        """Full receding-horizon plan (N, n_u) at state ``x`` (n_x,).

        Runs ``sqp_iters`` linearize->condense->solve passes seeded from
        the previous sample's plan shifted by one stage (hold-last)."""
        x = np.asarray(x, dtype=np.float32).reshape(self.n_x)
        if self.preview:
            # per-stage reference window r_1..r_N, flattened into p
            x_ref = (
                np.zeros(self.horizon * self.n_x, dtype=np.float32)
                if x_ref is None
                else np.asarray(x_ref, dtype=np.float32).reshape(
                    self.horizon * self.n_x
                )
            )
        else:
            x_ref = (
                np.zeros(self.n_x, dtype=np.float32)
                if x_ref is None
                else np.asarray(x_ref, dtype=np.float32).reshape(self.n_x)
            )
        if self._us is None:
            us = np.zeros((self.horizon, self.n_u), dtype=np.float32)
        else:  # shift the previous plan: drop u_0, hold the last move
            us = np.concatenate([self._us[1:], self._us[-1:]], axis=0)
        if self.device_condense:
            p = np.concatenate([x, x_ref]).astype(np.float32)
            if self.rate:
                u_prev = (
                    np.zeros(self.n_u, dtype=np.float32)
                    if self._u_prev is None
                    else self._u_prev
                )
                p = np.concatenate([p, u_prev])
            y_cold = jnp.zeros((2, self._m_h), jnp.float32)
            # warm_start semantics mirror the host path: the dual threads
            # across SQP passes and samples only when enabled; otherwise
            # every pass cold-starts (y0=None there, zeros here)
            y = (
                self._y
                if (self.warm_start and self._y is not None)
                else y_cold
            )
            us_j = jnp.asarray(us)
            res = None
            y_new = y
            for _ in range(self.sqp_iters):
                us_new, y_new, res = self._dev_pass(
                    jnp.asarray(x), us_j, jnp.asarray(p), y
                )
                if self.warm_start:
                    y = y_new
                us_j = us_j + self.damping * (us_new - us_j)
            us = np.asarray(us_j, dtype=np.float32)
            self._y = y_new
            self._us = us
            self.last_result = res
            if self.rate:
                self._u_prev = us[0]
            return us
        if self.engine == "stagewise":
            from tpu_gpad.stagewise import build_stagewise, solve_stagewise_jit

            res = None
            ref_bake = (
                x_ref.reshape(self.horizon, self.n_x)
                if self.preview
                else x_ref
            )
            for _ in range(self.sqp_iters):
                problem = self._linearized_problem(us, x)
                data = build_stagewise(
                    problem, iterations=self.config.iterations,
                    x_ref=ref_bake,
                )
                y0 = self._y if self.warm_start else None
                # jit-cached entry: SQP re-linearizes (new data every
                # iteration) but shapes are constant, so one trace serves
                # the whole closed loop (un-jitted solve_stagewise would
                # re-trace the 2N-step scan per call — DESIGN.md §11)
                res = solve_stagewise_jit(
                    data, jnp.asarray(x[None], dtype=jnp.float32),
                    y0=y0, config=self.config,
                )
                self._y = res.y
                us_new = np.asarray(
                    res.z[0], dtype=np.float32
                ).reshape(self.horizon, self.n_u)
                us = us + self.damping * (us_new - us)
            self._us = us
            self.last_result = res
            return us
        res = None
        for _ in range(self.sqp_iters):
            qp, data = self._qp_for(us, x)
            p = np.concatenate([x, x_ref])
            if self.rate:
                u_prev = (
                    np.zeros(self.n_u, dtype=np.float32)
                    if self._u_prev is None
                    else self._u_prev
                )
                p = np.concatenate([p, u_prev])
            y0 = self._y if self.warm_start else None
            res = solve_batch(
                data,
                jnp.asarray(p[None], dtype=jnp.float32),
                config=self.config,
                y0=y0,
            )
            self._y = res.y
            us_new = np.asarray(
                res.z[0, : self.n_u * self.horizon], dtype=np.float32
            ).reshape(self.horizon, self.n_u)
            us = us + self.damping * (us_new - us)
        self._us = us
        self.last_result = res
        if self.rate:
            self._u_prev = us[0]
        return us

    def step(self, x, x_ref=None) -> np.ndarray:
        """Applied move u_0 (n_u,) at state ``x``; see ``plan``."""
        return self.plan(x, x_ref)[0]

    def plan_batch(self, X, x_ref=None) -> np.ndarray:
        """Batch of B independent scenarios: plans of shape (B, N, n_u).

        Each scenario linearizes along ITS OWN nominal trajectory (vmapped
        rollout + Jacobians on device), condenses on host, and all B QPs
        solve in ONE vmapped device call via ``solve_multi`` — the
        nonlinear analogue of the reference's per-dataset host loop
        (``main.cu:104-108``). Keeps its own warm-start state, separate
        from the single-plant ``plan``; batch-size changes reset it."""
        from tpu_gpad.solver.multi import solve_multi, stack_data

        if self.engine == "stagewise":
            return self._plan_batch_stagewise(X, x_ref)
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        B = X.shape[0]
        ref_width = self.horizon * self.n_x if self.preview else self.n_x
        if x_ref is None:
            x_ref = np.zeros((B, ref_width), dtype=np.float32)
        else:  # one shared window/setpoint, or per-scenario (leading B)
            x_ref = np.asarray(x_ref, dtype=np.float32)
            x_ref = np.broadcast_to(
                x_ref.reshape(-1, ref_width) if x_ref.size == B * ref_width
                else x_ref.reshape(ref_width),
                (B, ref_width),
            ).astype(np.float32)
        if self._us_b is None or self._us_b.shape[0] != B:
            us = np.zeros((B, self.horizon, self.n_u), dtype=np.float32)
            self._y_b = None
            self._u_prev_b = None
        else:
            us = np.concatenate([self._us_b[:, 1:], self._us_b[:, -1:]], axis=1)
        if self.device_condense:
            P = np.concatenate([X, x_ref], axis=-1).astype(np.float32)
            if self.rate:
                u_prev = (
                    np.zeros((B, self.n_u), dtype=np.float32)
                    if self._u_prev_b is None
                    else self._u_prev_b
                )
                P = np.concatenate([P, u_prev], axis=-1)
            y_cold = jnp.zeros((B, 2, self._m_h), jnp.float32)
            y = (
                self._y_b
                if (self.warm_start and self._y_b is not None)
                else y_cold
            )
            us_j = jnp.asarray(us)
            res = None
            y_new = y
            for _ in range(self.sqp_iters):
                us_new, y_new, res = self._dev_pass_batch(
                    jnp.asarray(X), us_j, jnp.asarray(P), y
                )
                if self.warm_start:
                    y = y_new
                us_j = us_j + self.damping * (us_new - us_j)
            us = np.asarray(us_j, dtype=np.float32)
            self._y_b = y_new
            self._us_b = us
            self.last_result = res
            if self.rate:
                self._u_prev_b = us[:, 0]
            return us
        res = None
        for _ in range(self.sqp_iters):
            xs_next = jax.vmap(lambda x, u: rollout(self.f, x, u))(
                jnp.asarray(X), jnp.asarray(us)
            )
            xs_lin = jnp.concatenate(
                [jnp.asarray(X)[:, None], xs_next[:, :-1]], axis=1
            )
            A, Bm, c = jax.vmap(
                lambda xs, u: linearize(self.f, xs, u)
            )(xs_lin, jnp.asarray(us))
            A, Bm, c = map(partial(np.asarray, dtype=np.float64), (A, Bm, c))
            datas = []
            for b in range(B):
                problem = LinearMPCProblem(
                    A=A[b], B=Bm[b], Q=self.Q, R=self.R,
                    horizon=self.horizon, Q_terminal=self.Q_terminal,
                    c=c[b], name=self.name, **self.bounds,
                )
                qp = condense(
            problem,
            tracking="preview" if self.preview else True,
            soft_state=self.soft_state,
        )
                datas.append(dualize(
                    qp,
                    iterations=self.config.iterations,
                    paired="auto",
                    lipschitz=self.lipschitz,
                ))
            P = np.concatenate([X, x_ref], axis=-1)
            if self.rate:
                u_prev = (
                    np.zeros((B, self.n_u), dtype=np.float32)
                    if self._u_prev_b is None
                    else self._u_prev_b
                )
                P = np.concatenate([P, u_prev], axis=-1)
            y0 = self._y_b if self.warm_start else None
            res = solve_multi(
                stack_data(datas),
                jnp.asarray(P[:, None], dtype=jnp.float32),  # (B, 1, p)
                config=self.config,
                y0=y0,
            )
            self._y_b = res.y
            us_new = np.asarray(
                res.z[:, 0, : self.n_u * self.horizon], dtype=np.float32
            ).reshape(B, self.horizon, self.n_u)
            us = us + self.damping * (us_new - us)
        self._us_b = us
        self.last_result = res
        if self.rate:
            self._u_prev_b = us[:, 0]
        return us

    def _plan_batch_stagewise(self, X, x_ref) -> np.ndarray:
        """plan_batch on the stage-wise engine (long horizons): each
        scenario linearizes along ITS OWN trajectory, the B O(N)
        stage-wise builds stack (``stack_stagewise`` — host Riccati is
        the CHEAP side of this engine, 14-31x faster than condensing),
        and all B solves run in one vmapped device call
        (``solve_stagewise_multi``). References bake per scenario."""
        from tpu_gpad.stagewise import (
            build_stagewise,
            solve_stagewise_multi,
            stack_stagewise,
        )

        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        B = X.shape[0]
        ref_width = self.horizon * self.n_x if self.preview else self.n_x
        if x_ref is None:
            x_ref = np.zeros((B, ref_width), dtype=np.float32)
        else:
            x_ref = np.asarray(x_ref, dtype=np.float32)
            x_ref = np.broadcast_to(
                x_ref.reshape(-1, ref_width) if x_ref.size == B * ref_width
                else x_ref.reshape(ref_width),
                (B, ref_width),
            ).astype(np.float32)
        if self._us_b is None or self._us_b.shape[0] != B:
            us = np.zeros((B, self.horizon, self.n_u), dtype=np.float32)
            self._y_b = None
        else:
            us = np.concatenate(
                [self._us_b[:, 1:], self._us_b[:, -1:]], axis=1)
        res = None
        for _ in range(self.sqp_iters):
            xs_next = jax.vmap(lambda x, u: rollout(self.f, x, u))(
                jnp.asarray(X), jnp.asarray(us)
            )
            xs_lin = jnp.concatenate(
                [jnp.asarray(X)[:, None], xs_next[:, :-1]], axis=1
            )
            A, Bm, c = jax.vmap(
                lambda xs, u: linearize(self.f, xs, u)
            )(xs_lin, jnp.asarray(us))
            A, Bm, c = map(
                partial(np.asarray, dtype=np.float64), (A, Bm, c))
            datas = []
            for b in range(B):
                problem = LinearMPCProblem(
                    A=A[b], B=Bm[b], Q=self.Q, R=self.R,
                    horizon=self.horizon, Q_terminal=self.Q_terminal,
                    c=c[b], name=self.name, **self.bounds,
                )
                ref_b = (
                    x_ref[b].reshape(self.horizon, self.n_x)
                    if self.preview
                    else x_ref[b]
                )
                datas.append(build_stagewise(
                    problem, iterations=self.config.iterations,
                    x_ref=ref_b,
                ))
            stacked = stack_stagewise(datas)
            y0 = self._y_b if self.warm_start else None
            res = _nmpc_solve_stagewise_multi(
                stacked, jnp.asarray(X), y0, self.config
            )
            self._y_b = res.y
            us_new = np.asarray(res.z, dtype=np.float32).reshape(
                B, self.horizon, self.n_u)
            us = us + self.damping * (us_new - us)
        self._us_b = us
        self.last_result = res
        return us

    def step_batch(self, X, x_ref=None) -> np.ndarray:
        """Applied moves (B, n_u) for a batch of states; see ``plan_batch``."""
        return self.plan_batch(X, x_ref)[:, 0]

    def reset(self, u_prev=None) -> None:
        """Drop the plan/dual warm starts (plant or setpoint discontinuity).

        ``u_prev``: for rate-limited problems, the actuator's current
        position (default zeros)."""
        self._us = None
        self._y = None
        self._us_b = None
        self._y_b = None
        self._u_prev_b = None
        self._u_prev = (
            None if u_prev is None
            else np.asarray(u_prev, dtype=np.float32).reshape(self.n_u)
        )


class RobustNMPC:
    """Multi-model successive-linearization NMPC: one applied move that
    is optimal against S nonlinear model realizations simultaneously.

    The nonlinear composition of ``tpu_gpad.robust.scenario_qp`` with
    SL-NMPC: per SQP pass, every model ``f_s`` rolls out and linearizes
    along ITS OWN tail plan (all tails share the applied move u_0 by
    construction of the stacked QP), the S affine-LTV QPs stack with the
    shared-first-move selector, and one GPAD solve returns u_0 plus S
    scenario tails. Classic min-expected-cost robust NMPC under
    parametric model uncertainty — e.g. ``models`` built from parameter
    grid vertices of an uncertain plant.

    Cost/constraints are shared across scenarios (same Q/R/boxes);
    ``weights`` are the scenario probabilities. ``step(x, x_ref)``
    returns the applied move; ``plans`` after a step holds the (S, N,
    n_u) per-scenario tails. Host condensation per pass (S small dense
    float64 condensations) by default; ``device_condense=True`` fuses the
    S rollouts/linearizations, the shared-first-move scenario stack
    (``device_condense.dualize_scenario_device``) and the GPAD solve into
    ONE jitted device program per SQP pass — the same host-round-trip
    elimination plain ``NMPC`` got, now for the robust flagship.
    Requires input boxes, hard constraints only
    (no soft_state) and fixed-iteration mode."""

    def __init__(
        self,
        models,
        n_x: int,
        n_u: int,
        horizon: int,
        Q: np.ndarray,
        R: np.ndarray,
        weights=None,
        Q_terminal: Optional[np.ndarray] = None,
        x_min: Optional[np.ndarray] = None,
        x_max: Optional[np.ndarray] = None,
        u_min: Optional[np.ndarray] = None,
        u_max: Optional[np.ndarray] = None,
        soft_state: Optional[float] = None,
        iterations: int = 200,
        config: Optional[SolverConfig] = None,
        sqp_iters: int = 1,
        damping: float = 1.0,
        lipschitz: str = "spectral_dual",
        warm_start: bool = True,
        preview: bool = False,
        device_condense: bool = False,
        engine: str = "condensed",
        name: str = "robust_nmpc",
    ):
        if len(models) < 1:
            raise ValueError("need at least one model realization")
        if engine not in ("condensed", "stagewise"):
            raise ValueError(
                f"engine must be 'condensed' or 'stagewise': {engine!r}")
        if engine == "stagewise":
            # the O(N) robust stack (robust.scenario_stagewise_problem):
            # block plant + stage-0 non-anticipativity rows, for horizons
            # past the condensation wall
            if device_condense:
                raise ValueError(
                    "engine='stagewise' and device_condense are exclusive")
            if soft_state is not None:
                raise ValueError(
                    "engine='stagewise' does not take soft_state "
                    "(dual-damped rows are a condensation-path feature)")
            if len(models) < 2:
                raise ValueError(
                    "the stage-wise scenario stack needs >= 2 models")
        self.engine = engine
        if config is None:
            config = SolverConfig(iterations=iterations, restart=True)
        if config.iterations is None:
            import dataclasses

            config = dataclasses.replace(config, iterations=iterations)
        self.models = list(models)
        self.S = len(self.models)
        self.weights = weights
        self.n_x, self.n_u, self.horizon = n_x, n_u, horizon
        self.Q = np.asarray(Q, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.Q_terminal = Q_terminal
        self.bounds = dict(x_min=x_min, x_max=x_max, u_min=u_min, u_max=u_max)
        self.soft_state = soft_state
        self.config = config
        self.sqp_iters = sqp_iters
        self.damping = damping
        self.lipschitz = lipschitz
        self.warm_start = warm_start
        self.preview = preview  # per-stage references: x_ref is (N, n_x)
        self.name = name
        self.plans: np.ndarray | None = None  # (S, N, n_u) scenario tails
        self._y = None
        self.last_result = None
        self.device_condense = device_condense
        self._dev_pass = None
        if device_condense:
            # one fused device program per SQP pass (scenario twin of
            # NMPC(device_condense=True)); unsupported features fall back
            # loudly rather than silently taking the host path
            if u_min is None or u_max is None:
                raise ValueError("device_condense=True needs input boxes")
            if (x_min is None) != (x_max is None):
                raise ValueError(
                    "device_condense=True needs both state bounds or neither"
                )
            if config.mode != "fixed":
                raise ValueError(
                    "device_condense=True supports fixed-iteration mode"
                )
            n_tilde = n_u * (1 + self.S * (horizon - 1))
            self._m_h = (
                (self.S * n_x * horizon if x_min is not None else 0) + n_tilde
            )
            self._dev_pass = self._make_device_pass()

    def _make_device_pass(self):
        """One robust SQP pass as a single jitted device program:
        S rollouts + linearizations -> device scenario condensation
        (``dualize_scenario_device``) -> one GPAD solve, with the dual
        warm start threaded through."""
        from tpu_gpad.device_condense import dualize_scenario_device

        models, cfg = self.models, self.config
        Q, R, Q_T = self.Q, self.R, self.Q_terminal
        b, preview, w = self.bounds, self.preview, self.weights
        N, n_u, S = self.horizon, self.n_u, self.S
        tail = n_u * (N - 1)

        def one_pass(x, Us, p, y0):  # Us: (S, N, n_u)
            As, Bs, cs = [], [], []
            for s, f_s in enumerate(models):
                xs_next = rollout(f_s, x, Us[s])
                xs_lin = jnp.concatenate([x[None], xs_next[:-1]], axis=0)
                A_s, B_s, c_s = linearize(f_s, xs_lin, Us[s])
                As.append(A_s)
                Bs.append(B_s)
                cs.append(c_s)
            data = dualize_scenario_device(
                jnp.stack(As), jnp.stack(Bs), jnp.stack(cs), Q, R,
                b["u_min"], b["u_max"], iterations=cfg.iterations,
                weights=w, Q_terminal=Q_T,
                x_min=b["x_min"], x_max=b["x_max"],
                soft_state=self.soft_state, preview=preview,
                name=self.name,
            )
            res = solve_batch(data, p[None], config=cfg, y0=y0[None])
            z = res.z[0]
            plans = [
                jnp.concatenate(
                    [z[:n_u], z[n_u + s * tail : n_u + (s + 1) * tail]]
                ).reshape(N, n_u)
                for s in range(S)
            ]
            return jnp.stack(plans), res.y[0], res

        return jax.jit(one_pass)

    def plan(self, x, x_ref=None) -> np.ndarray:
        """One robust receding-horizon pass; returns the shared plan view
        of scenario 0 (its first move IS the applied move)."""
        from tpu_gpad.condense import condense, dualize
        from tpu_gpad.robust import scenario_plan, scenario_qp

        x = np.asarray(x, dtype=np.float32).reshape(self.n_x)
        ref_width = self.horizon * self.n_x if self.preview else self.n_x
        x_ref = (
            np.zeros(ref_width, dtype=np.float32)
            if x_ref is None
            else np.asarray(x_ref, dtype=np.float32).reshape(ref_width)
        )
        N, n_u, S = self.horizon, self.n_u, self.S
        if self.plans is None:
            Us = np.zeros((S, N, n_u), dtype=np.float32)
        else:  # shift every scenario tail, hold-last
            Us = np.concatenate(
                [self.plans[:, 1:], self.plans[:, -1:]], axis=1
            )
            # non-anticipativity of the STORED plans: after the shift the
            # first slots hold per-scenario second moves, which differ —
            # re-share them (their mean) so the damped update below keeps
            # every scenario's first move identical (the solved new[:, 0]
            # is shared by construction, but u0 + d*(new - u0) is only
            # shared if u0 is)
            Us[:, 0] = Us[:, 0].mean(axis=0)
        if self.device_condense:
            p = np.concatenate([x, x_ref]).astype(np.float32)
            y_cold = jnp.zeros((2, self._m_h), jnp.float32)
            y = (
                self._y
                if (self.warm_start and self._y is not None)
                else y_cold
            )
            Us_j = jnp.asarray(Us)
            res = None
            y_new = y
            for _ in range(self.sqp_iters):
                new, y_new, res = self._dev_pass(
                    jnp.asarray(x), Us_j, jnp.asarray(p), y
                )
                if self.warm_start:
                    y = y_new
                Us_j = Us_j + self.damping * (new - Us_j)
            Us = np.asarray(Us_j, dtype=np.float32)
            self.plans = Us
            self._y = y_new
            self.last_result = res
            return Us[0]
        if self.engine == "stagewise":
            from tpu_gpad.robust import (
                scenario_stagewise_plans,
                scenario_stagewise_problem,
                scenario_stagewise_x0,
            )
            from tpu_gpad.stagewise import build_stagewise, solve_stagewise_jit

            res = None
            ref_tiled = (
                np.tile(x_ref.reshape(N, self.n_x), (1, S))
                if self.preview
                else np.tile(x_ref, S)
            )
            for _ in range(self.sqp_iters):
                probs = []
                for s, f_s in enumerate(self.models):
                    us_s = jnp.asarray(Us[s])
                    xs_next = rollout(f_s, jnp.asarray(x), us_s)
                    xs_lin = jnp.concatenate(
                        [jnp.asarray(x)[None], xs_next[:-1]], axis=0
                    )
                    A, B, c = linearize(f_s, xs_lin, us_s)
                    probs.append(LinearMPCProblem(
                        A=np.asarray(A, dtype=np.float64),
                        B=np.asarray(B, dtype=np.float64),
                        Q=self.Q, R=self.R, horizon=N,
                        Q_terminal=self.Q_terminal,
                        c=np.asarray(c, dtype=np.float64),
                        name=f"{self.name}_s{s}", **self.bounds,
                    ))
                swp = scenario_stagewise_problem(
                    probs, weights=self.weights)
                data = build_stagewise(
                    swp, iterations=self.config.iterations,
                    x_ref=ref_tiled,
                )
                y0 = self._y if self.warm_start else None
                res = solve_stagewise_jit(
                    data,
                    jnp.asarray(
                        scenario_stagewise_x0(x, S)[None], jnp.float32),
                    y0=y0, config=self.config,
                )
                self._y = res.y
                new = scenario_stagewise_plans(
                    np.asarray(res.z[0], np.float32), S, n_u, N)
                Us = Us + self.damping * (new - Us)
            self.plans = Us.astype(np.float32)
            self.last_result = res
            return self.plans[0]
        res = None
        for _ in range(self.sqp_iters):
            qps = []
            for s, f_s in enumerate(self.models):
                us_s = jnp.asarray(Us[s])
                xs_next = rollout(f_s, jnp.asarray(x), us_s)
                xs_lin = jnp.concatenate(
                    [jnp.asarray(x)[None], xs_next[:-1]], axis=0
                )
                A, B, c = linearize(f_s, xs_lin, us_s)
                problem = LinearMPCProblem(
                    A=np.asarray(A, dtype=np.float64),
                    B=np.asarray(B, dtype=np.float64),
                    Q=self.Q,
                    R=self.R,
                    horizon=N,
                    Q_terminal=self.Q_terminal,
                    c=np.asarray(c, dtype=np.float64),
                    name=f"{self.name}_s{s}",
                    **self.bounds,
                )
                qps.append(
                    condense(
                        problem,
                        tracking="preview" if self.preview else True,
                        soft_state=self.soft_state,
                    )
                )
            qp_rob = scenario_qp(qps, weights=self.weights)
            data = dualize(
                qp_rob, iterations=self.config.iterations, paired="auto",
                lipschitz=self.lipschitz,
            )
            p = np.concatenate([x, x_ref])
            y0 = self._y if self.warm_start else None
            if y0 is not None and np.asarray(y0).shape[-1] * 2 != data.m:
                y0 = None  # dedupe changed the stack between passes
            res = solve_batch(
                data, jnp.asarray(p[None], dtype=jnp.float32),
                config=self.config, y0=y0,
            )
            self._y = res.y
            z = np.asarray(res.z[0], dtype=np.float32)
            new = np.stack(
                [scenario_plan(z, s, n_u, N, S) for s in range(S)]
            )
            Us = Us + self.damping * (new - Us)
        self.plans = Us
        self.last_result = res
        return Us[0]

    def step(self, x, x_ref=None) -> np.ndarray:
        """The applied move u_0 (shared across every realization)."""
        return self.plan(x, x_ref)[0]

    def reset(self) -> None:
        self.plans = None
        self._y = None


def simulate_nonlinear_device(
    plant: Callable,
    controller: NMPC,
    x0: np.ndarray,
    n_steps: int,
    x_ref=None,
) -> tuple[np.ndarray, np.ndarray]:
    """The ENTIRE nonlinear closed loop as ONE jitted device program.

    Requires ``controller.device_condense``: each sample's SQP pass
    (rollout, Jacobians, condensation, dualization, GPAD solve) is
    already a device program, so the whole receding-horizon simulation —
    the nonlinear analogue of the reference's 1000-sample ``gpad.m``
    loop — fuses into a single ``lax.scan``: one host->device call per
    TRAJECTORY instead of per sample. Plan and dual warm starts carry
    through the scan exactly as the host loop threads them.

    ``plant`` may differ from the controller's model ``f`` (robustness
    experiments) but must be jax-traceable. For ``preview=True``
    controllers ``x_ref`` is a full (T, n_x) reference trajectory
    (receding windows are dynamic slices of it, final row held);
    otherwise a fixed setpoint (n_x,). Returns ``(X, U)`` of shapes
    (n_steps + 1, n_x) / (n_steps, n_u) as NumPy.
    """
    if not controller.device_condense:
        raise ValueError(
            "simulate_nonlinear_device needs NMPC(device_condense=True); "
            "use simulate_nonlinear for host-condensed controllers"
        )
    c = controller
    N, n_x, n_u = c.horizon, c.n_x, c.n_u
    x0 = jnp.asarray(np.asarray(x0, dtype=np.float32).reshape(n_x))
    if c.preview:
        from tpu_gpad.closed_loop import pad_reference

        traj = jnp.asarray(pad_reference(
            np.zeros((1, n_x), np.float32) if x_ref is None else x_ref,
            n_steps + N + 1,
        ))

        def ref_at(t):
            return jax.lax.dynamic_slice_in_dim(traj, t + 1, N).reshape(
                N * n_x
            )
    else:
        setpoint = jnp.asarray(
            np.zeros(n_x, np.float32) if x_ref is None
            else np.asarray(x_ref, dtype=np.float32).reshape(n_x)
        )

        def ref_at(t):
            return setpoint

    one_pass = c._dev_pass  # nested jit inlines into the scan body
    sqp_iters, damping, warm = c.sqp_iters, c.damping, c.warm_start
    rate = c.rate

    # the actuator's current position (controller.reset(u_prev=...)) seeds
    # the first slew constraint, exactly like the host loop
    u_prev_start = jnp.asarray(
        np.zeros(n_u, np.float32)
        if c._u_prev is None
        else np.asarray(c._u_prev, np.float32).reshape(n_u)
    )

    @partial(jax.jit, static_argnums=1)
    def run(x0, n_steps):
        us0 = jnp.zeros((N, n_u), jnp.float32)
        y0 = jnp.zeros((2, c._m_h), jnp.float32)
        u_prev0 = u_prev_start

        def body(carry, t):
            x, us, y, u_prev = carry
            us = jnp.concatenate([us[1:], us[-1:]], axis=0)  # hold-last shift
            p = jnp.concatenate([x, ref_at(t)])
            if rate:  # slew limits reference the previously APPLIED move
                p = jnp.concatenate([p, u_prev])
            # warm_start=False cold-starts the dual every pass, exactly
            # like the host loop's y0=None (the plan still threads)
            y_in = y if warm else y0
            for _ in range(sqp_iters):
                us_new, y_next, _ = one_pass(x, us, p, y_in)
                if warm:
                    y_in = y_next
                us = us + damping * (us_new - us)
            u = us[0]
            x_next = plant(x, u)
            return (x_next, us, y_next if warm else y, u), (x_next, u)

        _, (X, U) = jax.lax.scan(
            body, (x0, us0, y0, u_prev0), jnp.arange(n_steps)
        )
        return X, U

    X, U = run(x0, n_steps)
    X = np.concatenate([np.asarray(x0)[None], np.asarray(X)], axis=0)
    return X, np.asarray(U)


def simulate_nonlinear(
    plant: Callable,
    controller: NMPC,
    x0: np.ndarray,
    n_steps: int,
    x_ref=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Closed loop: ``u = controller.step(x, x_ref)``, ``x+ = plant(x, u)``.

    ``plant`` may differ from the controller's model ``f`` (robustness
    experiments). Host loop by design — each sample re-linearizes and
    re-condenses (cf. ``closed_loop.simulate``, which can fuse the whole
    LTI loop into one jitted scan precisely because its QP is fixed).
    For a ``preview=True`` controller, ``x_ref`` is a full reference
    TRAJECTORY (T, n_x): sample t previews the receding window
    ``x_ref[t+1 : t+N+1]``, holding the final row once it runs out.
    Returns ``(X, U)`` with shapes (n_steps + 1, n_x) and (n_steps, n_u).
    """
    x = np.asarray(x0, dtype=np.float32).reshape(controller.n_x)
    traj = None
    if controller.preview and x_ref is not None:
        from tpu_gpad.closed_loop import pad_reference

        traj = pad_reference(x_ref, n_steps + controller.horizon + 1)
    X, U = [x], []
    for t in range(n_steps):
        ref = traj[t + 1 : t + 1 + controller.horizon] if traj is not None else x_ref
        u = controller.step(x, ref)
        x = np.asarray(
            plant(jnp.asarray(x), jnp.asarray(u)), dtype=np.float32
        )
        X.append(x)
        U.append(u)
    return np.stack(X), np.stack(U)

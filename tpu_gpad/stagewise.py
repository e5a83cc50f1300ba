"""Non-condensed (stage-wise) GPAD: the paper's O(N) variant.

The reference condenses the MPC QP before dualizing, so every GPAD
iteration pays two dense MVPs of O(N^2 * n_u * n_x) flops and the operand
matrices ``M_G``/``G_L`` grow as O(N^2) in memory (``gpad.m:50-63`` builds
the dense prediction matrices; ``kernel_functions.cu:16-64,142-200`` are
the dense MVP kernels). The GPAD paper explicitly notes the alternative
(`Documents/nmpc12-gpad.pdf` p.3): keep the states as decision variables
and the dynamics as equality constraints, and the dual-gradient oracle

    zhat(w) = argmin_z  0.5 z' M z + (f + G' w)' z

becomes a finite-horizon LQR with stage-wise linear cost perturbations —
solvable in O(N * (n_x + n_u)^2) per iteration by a Riccati recursion whose
QUADRATIC part is w-independent and precomputed offline. The reference never
implements this (SURVEY.md section 5, "long-context" row: the O(N)
non-condensed alternative is "not implemented").

This module is that variant:

- offline (float64 NumPy, like ``condense``): the Riccati gain sequence
  ``K_k``, closed-loop transitions ``E_k = A_k - B_k K_k`` and inverted
  input Hessians ``Hi_k = (R_k + B_k' Ptilde_{k+1} B_k)^-1``;
- online (jitted): each GPAD iteration runs ONE backward affine sweep and
  ONE forward rollout as ``lax.scan``s — after ``vmap`` over scenarios the
  scan body is (B, n) @ (n, n) batched matmuls;
- constraints stay stage-local (state/input boxes, per-stage coupling and
  polytopes), so applying ``G`` and ``G'`` is two small einsums per stage
  instead of a dense (m x n_z) contraction.

Per-iteration cost and memory are O(N) instead of O(N^2): the condensed
operands for e.g. battery n=30, N=200 are ~300 MB, while the stage-wise
data is ~2 MB at the same shape. The trade is sequential depth (2N sweep
steps per iteration vs one matmul), answered by two XLA executors behind
one auto-routed API: parallel-prefix ``associative_scan`` sweeps (small
state, latency regime) and the plain ``lax.scan`` path.

Scope: hard per-stage constraints, LTI or LTV dynamics, per-stage Q/R and
``Q_terminal``, affine dynamics offsets ``c_k`` and a build-time-fixed
tracking reference (both ride precomputed dtl/qoff constants — this is
what ``NMPC(engine="stagewise")`` linearizes onto for long-horizon SQP).
Rate limits, soft constraints and RUNTIME tracking parameters are
condensation-path features; ``build_stagewise`` rejects them loudly.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from tpu_gpad.types import LinearMPCProblem, SolveResult, _register_pytree_dataclass
from tpu_gpad.schedule import momentum_schedule

_HI = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class StagewiseData:
    """Offline-precomputed constants for the stage-wise GPAD solver.

    Shapes: N = horizon, n = n_x, p = n_u; ``m_x`` state-constraint rows
    per stage (stages 1..N), ``m_u`` input rows per stage (stages 0..N-1).

    The LQR backward recursion for the affine value-function term
    ``stilde_k`` (the only w-dependent part — the quadratic part is baked
    into ``K``/``Hi``/``E``) is

        stilde_N = qx_N
        stilde_k = qx_k + E_k' stilde_{k+1} - K_k' ru_k      (k = N-1..1)

    and the forward rollout is

        u_k = -K_k x_k - Hi_k (B_k' stilde_{k+1} + ru_k)
        x_{k+1} = A_k x_k + B_k u_k.
    """

    A_seq: jax.Array  # (N, n, n)
    B_seq: jax.Array  # (N, n, p)
    K: jax.Array  # (N, p, n) Riccati gains
    Hi: jax.Array  # (N, p, p) inverted input Hessians
    E: jax.Array  # (N, n, n) closed-loop transitions A_k - B_k K_k
    Gx: jax.Array  # (m_x, n) per-stage state rows: Gx x_k <= hx_k, k = 1..N
    hx: jax.Array  # (N, m_x)
    Gu: jax.Array  # (m_u, p) per-stage input rows: Gu u_k <= hu_k, k = 0..N-1
    hu: jax.Array  # (N, m_u)
    L: jax.Array  # () Lipschitz constant of the dual gradient
    theta: jax.Array  # (max_iters,) shipped momentum schedule
    beta: jax.Array  # (max_iters,)
    # affine-dynamics / linear-cost constants (zeros when unused):
    c_seq: jax.Array = None  # (N, n) dynamics offsets c_k
    dtl: jax.Array = None  # (N, n) Ptilde_{k+1} c_k (adds to stilde at kff)
    qoff: jax.Array = None  # (N, n) E'dtl shift + fixed-reference -Q x_ref
    Pt: jax.Array = None  # (N, n, n) Ptilde_{k+1} value-function Hessians,
    # kept so RUNTIME affine offsets (solve_stagewise(c=...)) can form
    # their dtl per solve — the device twin of build's dtl computation
    n_x: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_u: int = dataclasses.field(metadata=dict(static=True), default=0)
    horizon: int = dataclasses.field(metadata=dict(static=True), default=0)
    name: str = dataclasses.field(metadata=dict(static=True), default="stagewise")

    @property
    def m_x(self) -> int:
        return self.Gx.shape[0]

    @property
    def m_u(self) -> int:
        return self.Gu.shape[0]

    @property
    def m(self) -> int:
        """Total inequality rows (== the condensed stack's m)."""
        return self.horizon * (self.m_x + self.m_u)

    @property
    def max_iters(self) -> int:
        return self.theta.shape[0]


_register_pytree_dataclass(
    StagewiseData,
    data_fields=(
        "A_seq",
        "B_seq",
        "K",
        "Hi",
        "E",
        "Gx",
        "hx",
        "Gu",
        "hu",
        "L",
        "theta",
        "beta",
        "c_seq",
        "dtl",
        "qoff",
        "Pt",
    ),
    meta_fields=("n_x", "n_u", "horizon", "name"),
)


def _stage_seq(M, N: int, shape: tuple, name: str) -> np.ndarray:
    """Broadcast a constant or stacked per-stage matrix to (N, *shape)."""
    arr = np.asarray(M, dtype=np.float64)
    if arr.shape == shape:
        return np.broadcast_to(arr, (N, *shape)).copy()
    if arr.shape == (N, *shape):
        return arr.copy()
    raise ValueError(f"{name} must be {shape} or {(N, *shape)}; got {arr.shape}")


def _stage_rhs(v, N: int, q: int, name: str) -> np.ndarray:
    arr = np.asarray(v, dtype=np.float64)
    if arr.shape == (q,):
        return np.tile(arr, (N, 1))
    if arr.shape == (N, q):
        return arr.copy()
    raise ValueError(f"{name} must be ({q},) or ({N}, {q}); got {arr.shape}")


def _constraint_rows(problem: LinearMPCProblem):
    """Per-stage constraint rows (Gx, hx, Gu, hu) in float64.

    Same constraint set as ``condense`` builds into the dense stack
    (reference ``gpad.m:84-85``: [S; -S; I; -I; K; -K]), expressed
    stage-locally. Row ORDER differs from the condensed stack — GPAD's
    iterates are row-permutation-equivariant, so u*/z* (and the dual
    values per constraint) are unaffected.
    """
    n, p, N = problem.n_x, problem.n_u, problem.horizon
    gx_rows, hx_rows = [], []
    if problem.x_max is not None:
        gx_rows.append(np.eye(n))
        hx_rows.append(_stage_rhs(problem.x_max, N, n, "x_max"))
    if problem.x_min is not None:
        gx_rows.append(-np.eye(n))
        hx_rows.append(-_stage_rhs(problem.x_min, N, n, "x_min"))
    if problem.H_x is not None:
        Hx = np.asarray(problem.H_x, dtype=np.float64)
        gx_rows.append(Hx)
        hx_rows.append(_stage_rhs(problem.h_x, N, Hx.shape[0], "h_x"))
    gu_rows, hu_rows = [], []
    if problem.u_max is not None:
        gu_rows.append(np.eye(p))
        hu_rows.append(_stage_rhs(problem.u_max, N, p, "u_max"))
    if problem.u_min is not None:
        gu_rows.append(-np.eye(p))
        hu_rows.append(-_stage_rhs(problem.u_min, N, p, "u_min"))
    if problem.K_u is not None:
        Ku = np.asarray(problem.K_u, dtype=np.float64)
        zeros = np.zeros((N, Ku.shape[0]))
        gu_rows += [Ku, -Ku]
        hu_rows += [zeros, zeros]
    if problem.H_u is not None:
        Hu = np.asarray(problem.H_u, dtype=np.float64)
        gu_rows.append(Hu)
        hu_rows.append(_stage_rhs(problem.h_u, N, Hu.shape[0], "h_u"))
    Gx = np.concatenate(gx_rows, axis=0) if gx_rows else np.zeros((0, n))
    hx = np.concatenate(hx_rows, axis=1) if hx_rows else np.zeros((N, 0))
    Gu = np.concatenate(gu_rows, axis=0) if gu_rows else np.zeros((0, p))
    hu = np.concatenate(hu_rows, axis=1) if hu_rows else np.zeros((N, 0))
    return Gx, hx, Gu, hu


def _riccati_np(A_seq, B_seq, Q_seq, R_seq, Q_terminal):
    """Backward Riccati sweep (float64): gains K, inverses Hi, closed-loop E.

    ``Q_seq[j]`` weights stage j+1's state (the condensed cost's convention:
    states x_1..x_N carry cost, x_0 does not — ``condense.condense``), with
    ``Q_terminal`` replacing stage N's weight when given.
    """
    N, n, p = A_seq.shape[0], A_seq.shape[1], B_seq.shape[2]
    K = np.zeros((N, p, n))
    Hi = np.zeros((N, p, p))
    E = np.zeros((N, n, n))
    Pt_seq = np.zeros((N, n, n))  # Pt_seq[k] = Ptilde_{k+1}
    # Ptilde_{k+1} = Q_{k+1} + P_{k+1}: value-function Hessian INCLUDING
    # stage k+1's own cost, the quantity the k-th minimization sees.
    Pt = (Q_terminal if Q_terminal is not None else Q_seq[N - 1]).copy()
    for k in range(N - 1, -1, -1):
        A, B = A_seq[k], B_seq[k]
        Pt_seq[k] = Pt
        Hk = R_seq[k] + B.T @ Pt @ B
        Hk = 0.5 * (Hk + Hk.T)
        BtPtA = B.T @ Pt @ A
        K[k] = np.linalg.solve(Hk, BtPtA)
        Hi[k] = np.linalg.inv(Hk)
        E[k] = A - B @ K[k]
        P = A.T @ Pt @ A - BtPtA.T @ K[k]
        P = 0.5 * (P + P.T)
        if k > 0:
            Pt = Q_seq[k - 1] + P
    return K, Hi, E, Pt_seq


def _lqr_np(mats, qx, ru, x0):
    """NumPy twin of the online LQR solve (offline use: L estimation)."""
    A, B, K, Hi, E, N = mats
    stilde = np.zeros((N, qx.shape[1]))
    s = qx[N - 1]
    stilde[N - 1] = s
    for k in range(N - 1, 0, -1):
        s = qx[k - 1] + E[k].T @ s - K[k].T @ ru[k]
        stilde[k - 1] = s
    x = x0
    xs = np.zeros((N, x0.shape[0]))
    us = np.zeros((N, K.shape[1]))
    for k in range(N):
        kff = Hi[k] @ (B[k].T @ stilde[k] + ru[k])
        u = -K[k] @ x - kff
        x = A[k] @ x + B[k] @ u
        us[k] = u
        xs[k] = x
    return xs, us


def _cert_L_np(A_seq, B_seq, Gx, Gu, R_seq) -> float:
    """Certified upper bound on lambda_max(G M^-1 G') INCLUDING the
    prediction-map gain.

    In the dynamics-eliminated space the dual Hessian is
    ``Gc Mc^-1 Gc'`` with ``Mc = R_total + Gamma' Q_total Gamma >=
    lmin(R) I`` and ``Gc`` the condensed constraint matrix whose state
    rows act through the prediction map ``Gamma``. Hence

        lambda_max <= |Gc|_2^2 / lmin(R) <= |Gc|_F^2 / lmin(R),

    and ``|Gc|_F^2`` is computed EXACTLY (no rollout sampling) by the
    backward Gramian recursion ``S_s = Gx'Gx + A_s' S_{s+1} A_s`` with
    ``S_N = Gx'Gx``: the u_j column block contributes
    ``tr(B_j' S_{j+1} B_j)`` (states x_{j+1}..x_N through Phi_{t,j+1})
    plus the direct input rows ``|Gu|_F^2``. O(N n^3) offline — the
    naive ``N |G|_F^2 / lmin(R)`` bound that ignored Gamma was measured
    2.3-300x BELOW the true spectral L on unstable plants (round-3
    advisor finding) and is gone.
    """
    N = A_seq.shape[0]
    lmin_R = min(float(np.linalg.eigvalsh(Rk)[0]) for Rk in R_seq)
    GtG = Gx.T @ Gx
    S = GtG.copy()  # S_N
    fro2 = 0.0
    for j in range(N - 1, -1, -1):
        fro2 += float(np.trace(B_seq[j].T @ S @ B_seq[j]))  # S == S_{j+1}
        if j > 0:
            S = GtG + A_seq[j].T @ S @ A_seq[j]
    fro2 += N * float((Gu * Gu).sum())
    return fro2 / lmin_R


def _power_lmax_np(mats, Gx, Gu, seed: int = 0, iters: int = 500):
    """lambda_max of the dual Hessian G M^-1 G' by power iteration on the
    matrix-free operator (one LQR solve per step). Returns (lmax, rel_res).

    The operator is v -> -G * lqr(G' v, x0=0): the LQR minimizer of
    0.5 z'Mz + (G'v)'z is -M^-1 G' v, so its constraint image is -Hd v.
    """
    A, B, K, Hi, E, N = mats
    rng = np.random.default_rng(seed)
    vx = rng.standard_normal((N, Gx.shape[0]))
    vu = rng.standard_normal((N, Gu.shape[0]))
    lam, res = 0.0, np.inf

    def op(vx, vu):
        xs, us = _lqr_np(mats, vx @ Gx, vu @ Gu, np.zeros(A.shape[1]))
        return -(xs @ Gx.T), -(us @ Gu.T)

    for _ in range(iters):
        nrm = float(np.sqrt((vx * vx).sum() + (vu * vu).sum()))
        if nrm == 0.0:
            return 0.0, 0.0
        vx, vu = vx / nrm, vu / nrm
        wx, wu = op(vx, vu)
        lam = float((vx * wx).sum() + (vu * wu).sum())
        res = float(
            np.sqrt(((wx - lam * vx) ** 2).sum() + ((wu - lam * vu) ** 2).sum())
        )
        if lam > 0 and res / lam < 1e-8:
            break
        vx, vu = wx, wu
    return lam, (res / lam if lam > 0 else np.inf)


def stagewise_compatible(problem: LinearMPCProblem) -> tuple:
    """(ok, reason): can ``build_stagewise`` represent this problem?

    The stage-wise oracle needs stage-separable data: rate limits couple
    adjacent stages, so they are a condensation-path feature (the checks
    mirror ``build_stagewise``'s own loud rejections). Affine dynamics
    offsets ARE supported (precomputed dtl/qoff constants)."""
    if problem.du_min is not None or problem.du_max is not None:
        return False, "rate limits couple adjacent stages"
    has_rows = any(
        getattr(problem, f) is not None
        for f in ("x_min", "x_max", "u_min", "u_max", "K_u", "H_x", "H_u")
    )
    if not has_rows:
        return False, "no inequality constraints to dualize"
    return True, ""


def condensed_operand_mb(problem: LinearMPCProblem) -> float:
    """Projected fp32 device bytes (MB) of the two condensed MVP operands
    ``M_G``/``G_L`` at the FULL (unpaired-equivalent) stack — the O(N^2)
    memory the stage-wise engine avoids. Closed form, nothing built."""
    N, n, p = problem.horizon, problem.n_x, problem.n_u
    m = 0
    for lo, hi, q in (
        (problem.x_min, problem.x_max, n),
        (problem.u_min, problem.u_max, p),
    ):
        m += q * ((lo is not None) + (hi is not None))
    if problem.K_u is not None:
        m += 2 * np.asarray(problem.K_u).shape[0]
    if problem.H_x is not None:
        m += np.asarray(problem.H_x).shape[0]
    if problem.H_u is not None:
        m += np.asarray(problem.H_u).shape[0]
    return 2 * (N * m) * (N * p) * 4 / 1e6


def build_stagewise(
    problem: LinearMPCProblem,
    iterations: int = 100,
    L: Optional[float] = None,
    schedule: str = "paper",
    x_ref=None,
    dtype=jnp.float32,
) -> StagewiseData:
    """Precompute the stage-wise GPAD constants (O(N) data, float64 offline).

    Affine dynamics offsets (``problem.c``) and a FIXED tracking
    reference (``x_ref``, constant or (N, n) per-stage) are supported as
    precomputed per-stage constants: the LQR oracle's affine sweep gains
    ``dtl_k = Ptilde_{k+1} c_k`` (enters the feedforward) and a folded
    linear-cost shift ``qoff_k = E_{k+1}' dtl_{k+1} - Q_{k+1} r_{k+1}``
    — both w-independent, so the online cost is two adds. (A per-solve
    runtime reference remains a condensation-path feature; rebuild for a
    new setpoint, like the reference rebuilds its problem file.)

    ``L``: Lipschitz constant of the dual gradient; pass one (e.g.
    ``condense.lipschitz_constant`` on the condensed twin, for exact
    iterate parity with the condensed engines) or leave None for a
    matrix-free power-iteration estimate with a safety margin scaled by
    the iteration's convergence residual — an UNDERestimated L breaks the
    GPAD guarantee, so poor power-method convergence falls back to the
    certified backward-Gramian bound |Gc|_F^2 / lambda_min(R) computed by
    ``_cert_L_np`` (includes the prediction-map gain; see its docstring).
    """
    if problem.du_min is not None or problem.du_max is not None:
        raise ValueError(
            "rate limits couple adjacent stages; use the condensation path "
            "(condense + dualize), which augments the parameter with u_prev"
        )
    if (problem.H_x is None) != (problem.h_x is None) or (
        problem.H_u is None
    ) != (problem.h_u is None):
        raise ValueError("H_x/h_x and H_u/h_u must be given together")
    N, n, p = problem.horizon, problem.n_x, problem.n_u
    A_seq = _stage_seq(problem.A, N, (n, n), "A")
    B_seq = _stage_seq(problem.B, N, (n, p), "B")
    Q_seq = _stage_seq(problem.Q, N, (n, n), "Q")
    R_seq = _stage_seq(problem.R, N, (p, p), "R")
    Q_term = (
        np.asarray(problem.Q_terminal, dtype=np.float64)
        if problem.Q_terminal is not None
        else None
    )
    K, Hi, E, Pt_seq = _riccati_np(A_seq, B_seq, Q_seq, R_seq, Q_term)
    Gx, hx, Gu, hu = _constraint_rows(problem)
    if Gx.shape[0] == 0 and Gu.shape[0] == 0:
        raise ValueError("problem has no inequality constraints to dualize")

    if L is None:
        mats = (A_seq, B_seq, K, Hi, E, N)
        lam, rel_res = _power_lmax_np(mats, Gx, Gu)
        if rel_res < 1e-6:
            L = lam * 1.01
        elif rel_res < 1e-3:
            L = lam * 1.1
        else:
            # power iteration failed to certify; lam (a Rayleigh quotient)
            # is still a LOWER bound on lambda_max, so the certified
            # Gramian bound >= lambda_max >= lam — the max is a floating-
            # point belt-and-braces, not a semantic choice.
            L = max(1.1 * lam, _cert_L_np(A_seq, B_seq, Gx, Gu, R_seq))
    L = float(L)
    if L <= 0:
        raise ValueError(f"Lipschitz constant must be positive; got {L}")

    # affine-dynamics + fixed-reference constants (zeros when absent)
    c_seq = (
        _stage_rhs(problem.c, N, n, "c")
        if problem.c is not None
        else np.zeros((N, n))
    )
    dtl = np.einsum("kij,kj->ki", Pt_seq, c_seq)  # Ptilde_{k+1} c_k
    ecorr = np.einsum("kji,kj->ki", E, dtl)  # E_k' dtl_k
    qoff = np.zeros((N, n))
    qoff[:-1] += ecorr[1:]  # the bwd recursion's shift, folded into qx
    if x_ref is not None:
        ref = _stage_rhs(np.asarray(x_ref, dtype=np.float64), N, n, "x_ref")
        for k in range(N):
            Qk = (
                Q_term
                if (k == N - 1 and Q_term is not None)
                else Q_seq[k]
            )
            qoff[k] -= Qk @ ref[k]  # linear term of 0.5||x - r||_Q^2

    theta, beta = momentum_schedule(iterations, variant=schedule)
    as_dev = lambda a: jnp.asarray(a, dtype=dtype)
    return StagewiseData(
        A_seq=as_dev(A_seq),
        B_seq=as_dev(B_seq),
        K=as_dev(K),
        Hi=as_dev(Hi),
        E=as_dev(E),
        Gx=as_dev(Gx),
        hx=as_dev(hx),
        Gu=as_dev(Gu),
        hu=as_dev(hu),
        L=jnp.asarray(L, dtype=dtype),
        theta=jnp.asarray(theta, dtype=dtype),
        beta=jnp.asarray(beta, dtype=dtype),
        c_seq=as_dev(c_seq),
        dtl=as_dev(dtl),
        qoff=as_dev(qoff),
        Pt=as_dev(Pt_seq),
        n_x=n,
        n_u=p,
        horizon=N,
        name=f"{problem.name}_stagewise",
    )


# Routing constants of ``stagewise_preferred``. They were tuned on another
# accelerator and have not been re-measured on the GPU yet: treat each as
# a hypothesis until the benchmark re-measures the condensed/stage-wise
# crossover there.
#
# Hard memory backstop above which auto_solver always prefers the
# stage-wise engine (projected condensed MVP operand MB).
AUTO_STAGEWISE_ABOVE_MB = 256.0
# Any-batch horizon crossover for battery-class plants (n_x + n_u >= 10).
AUTO_STAGEWISE_HORIZON = 170
# Large-batch branch: from this horizon on, a known batch of at least 24 N
# prefers the stage-wise engine.
AUTO_STAGEWISE_MIN_HORIZON_BATCHED = 60


def stagewise_preferred(
    problem: LinearMPCProblem,
    batch_hint: Optional[int] = None,
    threshold_mb: Optional[float] = None,
) -> tuple:
    """(prefer, reason): should auto routing take the stage-wise engine?

    Stage-wise when (a) the projected condensed MVP operands exceed the
    ``threshold_mb`` memory backstop (default ``AUTO_STAGEWISE_ABOVE_MB``),
    (b) the horizon is past the any-batch crossover
    (``AUTO_STAGEWISE_HORIZON``), or (c) the batch is known
    (``batch_hint``) and large (``B >= 24 N`` at
    ``N >= AUTO_STAGEWISE_MIN_HORIZON_BATCHED``). Problems the stage-wise
    engine cannot represent never prefer it."""
    ok, reason = stagewise_compatible(problem)
    if not ok:
        return False, reason
    lim = AUTO_STAGEWISE_ABOVE_MB if threshold_mb is None else threshold_mb
    mb = condensed_operand_mb(problem)
    if mb > lim:
        return True, f"projected condensed operands {mb:.1f} MB > {lim:g} MB"
    N = problem.horizon
    # The throughput branches below hold for battery-class per-stage sizes
    # (n_x + n_u = 16..60). Tiny per-stage state (the MHE block problem,
    # the double integrator) has almost no math per sweep step to amortize
    # the 2N sequential steps, so only the memory backstop routes it
    # stage-wise.
    if problem.n_x + problem.n_u < 10:
        return False, (
            "per-stage state too small for the throughput crossover; "
            "memory backstop only")
    if N >= AUTO_STAGEWISE_HORIZON:
        return True, (
            f"horizon {N} >= {AUTO_STAGEWISE_HORIZON} (any-batch crossover)")
    if (
        batch_hint is not None
        and N >= AUTO_STAGEWISE_MIN_HORIZON_BATCHED
        and batch_hint >= 24 * N
    ):
        return True, (
            f"batch {batch_hint} >= 24*N at N={N} (large-batch branch)")
    return False, "condensed at this (N, batch)"


def auto_solver(
    problem: LinearMPCProblem,
    iterations: int = 100,
    threshold_mb: Optional[float] = None,
    batch_hint: Optional[int] = None,
    **build_kw,
):
    """Problem-level engine routing between condensed and stage-wise.

    Returns ``(solve_fn, data, kind)`` with ``kind`` in
    {"condensed", "stagewise"} and ``solve_fn(x0, config=None, **kw)``
    having the ``solve_batch``/``solve_stagewise`` calling convention
    (both accept a ``SolverConfig``). Routing is ``stagewise_preferred``
    (stage-wise at N >= 170 any batch, or N >= 60 with
    ``batch_hint >= 24 N``), with
    ``threshold_mb`` (default ``AUTO_STAGEWISE_ABOVE_MB``) as the hard
    memory backstop; condensation-path-only features (rate limits)
    always condense, and stage-wise-only build options (``x_ref``) force
    the stage-wise route. Pass ``batch_hint`` (the expected solve batch
    size) to enable the large-batch branch — without it routing is
    batch-agnostic and keeps the condensed engine below N=170. This
    closes the routing gap the condensed ``SolverConfig(engine="auto")``
    cannot see (it routes AFTER condensation already happened).

    Reference anchor: the condensation decision itself (``gpad.m:50-63``)
    — the reference has one formulation; this framework has both."""
    # NOTE: the package __init__ shadows the submodule name with the
    # function, so import the functions, not the module
    from tpu_gpad.condense import condense as _condense, dualize as _dualize

    prefer, _reason = stagewise_preferred(
        problem, batch_hint=batch_hint, threshold_mb=threshold_mb
    )
    if "x_ref" in build_kw and not prefer:
        # a baked tracking reference is a stage-wise-only build option
        # (condense() has no x_ref); route by feature, loudly failing only
        # where the engine truly cannot take the problem
        ok, reason = stagewise_compatible(problem)
        if not ok:
            raise ValueError(
                f"x_ref is a stage-wise build option but this problem "
                f"cannot route stage-wise: {reason}")
        prefer = True
    if prefer:
        data = build_stagewise(problem, iterations=iterations, **build_kw)

        def solve_fn(x0, config=None, **kw):
            return solve_stagewise(data, x0, config=config, **kw)

        return solve_fn, data, "stagewise"
    qp = _condense(problem)
    build_kw.setdefault("paired", "auto")
    data = _dualize(qp, iterations=iterations, **build_kw)

    def solve_fn(x0, config=None, **kw):
        from tpu_gpad.solver import solve_batch

        if config is None:
            return solve_batch(data, x0, **kw)
        return solve_batch(data, x0, config=config, **kw)

    return solve_fn, data, "condensed"


def _affine_combine(a, b):
    """Composition of affine maps x -> M x + v (associative): b after a."""
    Ma, va = a
    Mb, vb = b
    return (
        jnp.einsum("...ij,...jk->...ik", Mb, Ma, precision=_HI),
        jnp.einsum("...ij,...j->...i", Mb, va, precision=_HI) + vb,
    )


def _lqr_solve_assoc(
    data: StagewiseData, qx: jax.Array, ru: jax.Array, x0: jax.Array
):
    """Parallel-in-time LQR solve: both sweeps as ``associative_scan``s.

    The backward slope recursion s_k = E_k' s_{k+1} + c_k and the forward
    closed-loop rollout x_{k+1} = E_k x_k + d_k are first-order AFFINE
    recurrences, so their prefixes compose associatively — depth drops
    from N to log2(N) at an O(log N) work premium (the classic
    parallel-prefix Riccati sweep; ``lax.scan`` is work-optimal but
    serial). ``solve_stagewise``'s ``scan="auto"`` picks between them.
    """
    N = data.horizon
    s_N = qx[-1]
    if N > 1:
        # c_k = qx_{k} stage part - K_k' ru_k for k = 1..N-1, scanned from
        # the tail: element j composes the step s_{N-j+1} -> s_{N-j}
        c = qx[:-1] - jnp.einsum(
            "kpn,kp->kn", data.K[1:], ru[1:], precision=_HI
        )
        Mseq = jnp.flip(jnp.swapaxes(data.E[1:], -1, -2), axis=0)
        vseq = jnp.flip(c, axis=0)
        prefA, prefv = jax.lax.associative_scan(_affine_combine, (Mseq, vseq))
        s_vals = (
            jnp.einsum("kij,...j->k...i", prefA, s_N, precision=_HI) + prefv
        )  # s_{N-j}, j = 1..N-1
        stilde = jnp.concatenate([jnp.flip(s_vals, axis=0), s_N[None]], axis=0)
    else:
        stilde = s_N[None]
    # feedforwards are elementwise once stilde is known; affine dynamics
    # shift the slope by Ptilde_{k+1} c_k and the rollout by c_k
    stilde = stilde + data.dtl
    kff = jnp.einsum(
        "kpq,kq->kp",
        data.Hi,
        jnp.einsum("knp,kn->kp", data.B_seq, stilde, precision=_HI) + ru,
        precision=_HI,
    )
    d = -jnp.einsum("knp,kp->kn", data.B_seq, kff, precision=_HI) + data.c_seq
    prefA, prefv = jax.lax.associative_scan(_affine_combine, (data.E, d))
    xs = jnp.einsum("kij,j->ki", prefA, x0, precision=_HI) + prefv
    x_lin = jnp.concatenate([x0[None], xs[:-1]], axis=0)
    us = -jnp.einsum("kpn,kn->kp", data.K, x_lin, precision=_HI) - kff
    return xs, us


def _lqr_solve(data: StagewiseData, qx: jax.Array, ru: jax.Array, x0: jax.Array,
               unroll: int = 1):
    """Jitted LQR solve with linear-cost perturbations (qx, ru).

    Two ``lax.scan``s over the horizon; all contractions run at HIGHEST
    precision — the backward sweep chains N matmuls, and reduced-precision
    default matmuls (TF32 on a GPU) corrupt the chain exactly like the
    device-condensation KKT solves (docs/DESIGN.md section 9).
    """
    dot = lambda M, v: jnp.einsum("ij,...j->...i", M, v, precision=_HI)

    def bwd(s_next, inp):
        E_k, K_k, qx_prev, ru_k = inp
        s_k = qx_prev + dot(E_k.T, s_next) - dot(K_k.T, ru_k)
        return s_k, s_next

    s_N = qx[-1]
    s_1, stilde_tail = jax.lax.scan(
        bwd,
        s_N,
        (data.E[1:], data.K[1:], qx[:-1], ru[1:]),
        reverse=True,
        unroll=unroll,
    )
    # stilde[k] = stilde_{k+1}, the value-function slope the k-th stage sees
    stilde = jnp.concatenate([s_1[None], stilde_tail], axis=0)
    # affine dynamics: the feedforward sees stilde + Ptilde_{k+1} c_k
    # (the bwd recursion's shift is folded into qx via data.qoff)
    stilde = stilde + data.dtl

    def fwd(x, inp):
        A_k, B_k, K_k, Hi_k, st_k, ru_k, c_k = inp
        kff = dot(Hi_k, dot(B_k.T, st_k) + ru_k)
        u = -dot(K_k, x) - kff
        x_next = dot(A_k, x) + dot(B_k, u) + c_k
        return x_next, (x_next, u)

    _, (xs, us) = jax.lax.scan(
        fwd, x0,
        (data.A_seq, data.B_seq, data.K, data.Hi, stilde, ru, data.c_seq),
        unroll=unroll,
    )
    return xs, us


def _dual_oracle(
    data: StagewiseData,
    wx: jax.Array,
    wu: jax.Array,
    x0: jax.Array,
    scan: str = "sequential",
    unroll: int = 1,
):
    """zhat(w) and the dual gradient g(w) = G zhat - h, stage-local."""
    qx = jnp.einsum("kq,qn->kn", wx, data.Gx, precision=_HI) + data.qoff
    ru = jnp.einsum("kq,qp->kp", wu, data.Gu, precision=_HI)
    if scan == "associative":
        xs, us = _lqr_solve_assoc(data, qx, ru, x0)
    else:
        xs, us = _lqr_solve(data, qx, ru, x0, unroll=unroll)
    gx = jnp.einsum("kn,qn->kq", xs, data.Gx, precision=_HI) - data.hx
    gu = jnp.einsum("kp,qp->kq", us, data.Gu, precision=_HI) - data.hu
    return (xs, us), (gx, gu)


def _restart_reset(th, th_prev, yx, yu, yx_n, yu_n, wx, wu):
    """O'Donoghue-Candes adaptive restart on the stage-packed dual — the
    same test as the condensed engines (``core._restart_update``): reset
    the momentum recursion iff (w - y+) . (y+ - y) > 0."""
    r = jnp.sum((wx - yx_n) * (yx_n - yx)) + jnp.sum(
        (wu - yu_n) * (yu_n - yu)
    )
    mask = r > 0.0
    th_next = jnp.where(mask, 1.0, th * (jnp.sqrt(th * th + 4.0) - th) * 0.5)
    th_prev_next = jnp.where(mask, 1.0, th)
    yx_prev = jnp.where(mask, yx_n, yx)
    yu_prev = jnp.where(mask, yu_n, yu)
    return yx_prev, yu_prev, th_next, th_prev_next


def _solve_one(
    data: StagewiseData,
    x0: jax.Array,
    y0x: jax.Array,
    y0u: jax.Array,
    n_iters: int,
    scan: str,
    restart: bool = False,
    unroll: int = 1,
):
    N = data.horizon
    inv_L = 1.0 / data.L
    one = jnp.ones((), dtype=data.hx.dtype)

    def body(i, carry):
        yx, yu, yx_p, yu_p, zx, zu, th_c, th_p = carry
        if restart:
            th = th_c
            b = th_c * (1.0 / th_p - 1.0)
        else:
            b = data.beta[i]
            th = data.theta[i]
        wx = yx + b * (yx - yx_p)
        wu = yu + b * (yu - yu_p)
        (xs, us), (gx, gu) = _dual_oracle(data, wx, wu, x0, scan, unroll)
        zx = (1.0 - th) * zx + th * xs
        zu = (1.0 - th) * zu + th * us
        yx_n = jnp.maximum(wx + inv_L * gx, 0.0)
        yu_n = jnp.maximum(wu + inv_L * gu, 0.0)
        if restart:
            yx_p, yu_p, th_c, th_p = _restart_reset(
                th_c, th_p, yx, yu, yx_n, yu_n, wx, wu
            )
        else:
            yx_p, yu_p = yx, yu
        return yx_n, yu_n, yx_p, yu_p, zx, zu, th_c, th_p

    zx0 = jnp.zeros((N, data.n_x), dtype=data.hx.dtype)
    zu0 = jnp.zeros((N, data.n_u), dtype=data.hu.dtype)
    yx, yu, _, _, zx, zu, _, _ = jax.lax.fori_loop(
        0, n_iters, body, (y0x, y0u, y0x, y0u, zx0, zu0, one, one)
    )
    # epilogue diagnostics on the averaged primal (zx is the exact rollout
    # of zu from x0 — x is linear in u, and the convex combination step 3
    # preserves that)
    gx = jnp.einsum("kn,qn->kq", zx, data.Gx, precision=_HI) - data.hx
    gu = jnp.einsum("kp,qp->kq", zu, data.Gu, precision=_HI) - data.hu
    # core._residuals computes the unclamped max(G z - h) internally, but
    # every public SolveResult clamps it (core.py: maximum(viol_z, 0)) —
    # match that so cross-engine consumers see one semantics.
    residual = jnp.maximum(
        jnp.max(jnp.concatenate([gx.reshape(-1), gu.reshape(-1)])), 0.0
    )
    gap = -(jnp.sum(yx * gx) + jnp.sum(yu * gu))
    y_packed = jnp.concatenate([yx, yu], axis=-1)
    return (
        zu[0],
        zu.reshape(-1),
        y_packed,
        jnp.asarray(n_iters, jnp.int32),
        residual,
        gap,
        jnp.asarray(True),
    )


def _max_rows(gx, gu):
    """max over all constraint rows, tolerating an empty side (build
    guarantees at least one side has rows)."""
    if gx.shape[-1] and gu.shape[-1]:
        return jnp.maximum(jnp.max(gx), jnp.max(gu))
    return jnp.max(gx) if gx.shape[-1] else jnp.max(gu)


def _stage_viol(data: StagewiseData, xs, us):
    """max(G z - h) over all stage rows (unclamped — the internal
    core._residuals semantics used by the eps test; public results clamp)
    plus the raw per-row values for the gap."""
    gx = jnp.einsum("kn,qn->kq", xs, data.Gx, precision=_HI) - data.hx
    gu = jnp.einsum("kp,qp->kq", us, data.Gu, precision=_HI) - data.hu
    return gx, gu, _max_rows(gx, gu)


def _solve_one_eps(
    data: StagewiseData,
    x0: jax.Array,
    y0x: jax.Array,
    y0u: jax.Array,
    n_iters: int,
    scan: str,
    eps_g: float,
    eps_V: float,
    check_every: int,
    restart: bool,
    unroll: int = 1,
):
    """Algorithm-1 epsilon termination for the stage-wise engine: the
    check the reference comments out (``acceldualgrad.m:66-79``), run
    every ``check_every`` iterations on the stage-local residuals. Same
    exit criterion as ``core._solve_eps``: the averaged z primal-feasible
    to eps_g, OR zhat feasible to eps_g with duality-gap surrogate
    -w'g(zhat) <= eps_V (on that branch zhat is the eps-optimal point)."""
    N = data.horizon
    inv_L = 1.0 / data.L
    one = jnp.ones((), dtype=data.hx.dtype)
    zx0 = jnp.zeros((N, data.n_x), dtype=data.hx.dtype)
    zu0 = jnp.zeros((N, data.n_u), dtype=data.hu.dtype)

    def cond(carry):
        k, done = carry[0], carry[1]
        return jnp.logical_and(k < n_iters, jnp.logical_not(done))

    def body(carry):
        (k, conv, yx, yu, yx_p, yu_p, zx, zu, zu_out, u0_out, it,
         th_c, th_p) = carry
        if restart:
            th = th_c
            b = th_c * (1.0 / th_p - 1.0)
        else:
            b = data.beta[k]
            th = data.theta[k]
        wx = yx + b * (yx - yx_p)
        wu = yu + b * (yu - yu_p)
        (xs, us), (gx, gu) = _dual_oracle(data, wx, wu, x0, scan, unroll)
        zx = (1.0 - th) * zx + th * xs
        zu = (1.0 - th) * zu + th * us
        yx_n = jnp.maximum(wx + inv_L * gx, 0.0)
        yu_n = jnp.maximum(wu + inv_L * gu, 0.0)
        if restart:
            yx_p, yu_p, th_c, th_p = _restart_reset(
                th_c, th_p, yx, yu, yx_n, yu_n, wx, wu
            )
        else:
            yx_p, yu_p = yx, yu

        def check(args):
            conv, it, zu_out, u0_out = args
            # zhat residuals come free from the oracle call above
            viol_zhat = _max_rows(gx, gu)
            gap = -(jnp.sum(wx * gx) + jnp.sum(wu * gu))
            _, _, viol_z = _stage_viol(data, zx, zu)
            ok_z = viol_z <= eps_g
            ok_zhat = jnp.logical_and(viol_zhat <= eps_g, gap <= eps_V)
            ok = jnp.logical_or(ok_z, ok_zhat)
            newly = jnp.logical_and(ok, jnp.logical_not(conv))
            it = jnp.where(newly, k + 1, it)
            zu_sel = jnp.where(ok_z, zu, us)
            zu_out = jnp.where(newly, zu_sel, zu_out)
            u0_out = jnp.where(newly, zu_sel[0], u0_out)
            return jnp.logical_or(conv, ok), it, zu_out, u0_out

        do_check = jnp.logical_or(
            (k + 1) % check_every == 0, k + 1 == n_iters
        )
        conv, it, zu_out, u0_out = jax.lax.cond(
            do_check, check, lambda a: a, (conv, it, zu_out, u0_out)
        )
        return (k + 1, conv, yx_n, yu_n, yx_p, yu_p, zx, zu, zu_out,
                u0_out, it, th_c, th_p)

    carry = (
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        y0x, y0u, y0x, y0u, zx0, zu0, zu0,
        jnp.zeros((data.n_u,), dtype=data.hu.dtype),
        jnp.full((), n_iters, jnp.int32),
        one, one,
    )
    (_, conv, yx, yu, _, _, zx, zu, zu_out, u0_out, it, _, _) = (
        jax.lax.while_loop(cond, body, carry)
    )
    zu_f = jnp.where(conv, zu_out, zu)
    # exact rollout of the selected input trajectory for the residual
    xs_f = _rollout(data, zu_f, x0)
    gx, gu, viol = _stage_viol(data, xs_f, zu_f)
    residual = jnp.maximum(viol, 0.0)  # public SolveResult semantics
    gap = -(jnp.sum(yx * gx) + jnp.sum(yu * gu))
    y_packed = jnp.concatenate([yx, yu], axis=-1)
    return (
        jnp.where(conv, u0_out, zu[0]),
        zu_f.reshape(-1),
        y_packed,
        it,
        residual,
        gap,
        conv,
    )


def _rollout(data: StagewiseData, us: jax.Array, x0: jax.Array):
    """States x_1..x_N from an input trajectory (exact, scanned)."""

    def step(x, inp):
        A_k, B_k, u_k, c_k = inp
        x_n = (
            jnp.einsum("ij,j->i", A_k, x, precision=_HI)
            + jnp.einsum("ij,j->i", B_k, u_k, precision=_HI)
            + c_k
        )
        return x_n, x_n

    _, xs = jax.lax.scan(
        step, x0, (data.A_seq, data.B_seq, us, data.c_seq))
    return xs


def solve_stagewise(
    data: StagewiseData,
    x0: jax.Array,
    iterations: Optional[int] = None,
    y0: Optional[jax.Array] = None,
    scan: str = "auto",
    mode: str = "fixed",
    eps_g: float = 1e-6,
    eps_V: float = 1e-6,
    check_every: int = 10,
    restart: bool = False,
    unroll: int = 1,
    config=None,
    q_lin: Optional[jax.Array] = None,
    c: Optional[jax.Array] = None,
) -> SolveResult:
    """Solve a batch of MPC QPs via stage-wise GPAD; ``x0`` is (..., n_x).

    ``mode="fixed"`` is the hard-real-time budget, matching the reference
    runtime's only mode (``main.cu:87,160``); ``mode="eps"`` runs the
    paper's Algorithm-1 epsilon-optimality exit every ``check_every``
    iterations (the test the reference comments out,
    ``acceldualgrad.m:66-79``) — same criterion as the condensed engines.
    ``restart=True`` enables the O'Donoghue-Candes adaptive momentum
    restart (identical dual dynamics to ``core._restart_update``). Passing
    a ``SolverConfig`` as ``config`` reads iterations/mode/eps_g/eps_V/
    check_every/restart from it (explicit kwargs are then ignored).

    ``y0`` warm-starts the dual: shape broadcastable to
    (..., N, m_x + m_u) with state rows first per stage (the layout this
    function returns in ``SolveResult.y``).

    ``scan``: "auto" (default — parallel-prefix sweeps when the per-stage
    matrices are small, n_x + n_u <= 24, and the batch is below 1024,
    where the sequential scans are latency-bound; sequential otherwise),
    "sequential" (``lax.scan`` sweeps, work-optimal) or "associative"
    (parallel-prefix, depth log2(N) at an O(log N) work premium).
    ``unroll`` unrolls the sequential scan bodies.

    ``q_lin`` / ``c`` are PER-SOLVE runtime parameters (the stage-wise
    twin of the condensed parameter maps, ``acceldualgrad.m:20-23``):
    ``q_lin`` (broadcastable to (..., N, n_x)) adds a linear state-cost
    term ``q_lin_k . x_k`` per stage (e.g. a runtime tracking reference
    ``-Q r_k``, or MHE's measurement terms ``-C'V^-1 y_k``); ``c``
    (same shape) adds a runtime affine dynamics offset ``x_{k+1} +=
    c_k`` (e.g. MHE's known-input forcing ``B u_k``). Both compose with
    any build-time ``problem.c``/``x_ref`` constants.

    Returns a ``SolveResult`` with ``u`` = first move, ``z`` the full input
    trajectory (N*n_u, the condensed z convention), ``y`` the stage-packed
    dual, ``residual`` the max primal violation of the averaged iterate and
    ``gap`` the complementarity surrogate -y'g(z).
    """
    if config is not None:
        iterations = config.iterations
        mode = config.mode
        eps_g, eps_V = config.eps_g, config.eps_V
        check_every = config.check_every
        restart = config.restart
    if scan not in ("auto", "sequential", "associative"):
        raise ValueError(
            f"scan must be 'auto', 'sequential' or 'associative': {scan!r}")
    if mode not in ("fixed", "eps"):
        raise ValueError(f"mode must be 'fixed' or 'eps': {mode!r}")
    n_iters = int(iterations) if iterations is not None else data.max_iters
    if n_iters > data.max_iters and not restart:
        raise ValueError(
            f"asked for {n_iters} iterations but the shipped schedule has "
            f"{data.max_iters}; rebuild with a longer one (or use "
            f"restart=True, whose momentum recursion is schedule-free)"
        )
    x0 = jnp.asarray(x0)
    batch_shape = x0.shape[:-1]
    xb = x0.reshape((-1, data.n_x))
    B = xb.shape[0]
    N, m_x, m_u = data.horizon, data.m_x, data.m_u
    if y0 is None:
        y0x = jnp.zeros((B, N, m_x), dtype=data.hx.dtype)
        y0u = jnp.zeros((B, N, m_u), dtype=data.hu.dtype)
    else:
        y0 = jnp.broadcast_to(
            jnp.asarray(y0, dtype=data.hx.dtype), (*batch_shape, N, m_x + m_u)
        ).reshape((B, N, m_x + m_u))
        y0x, y0u = y0[..., :m_x], y0[..., m_x:]

    if scan == "auto":
        # small per-stage matrices at small batch: the sequential scans are
        # latency-bound and the log-depth sweeps win; large state or a
        # batch that amortizes the scan pays for the O(log N) extra work.
        # Tuned on another accelerator; not yet re-measured on the GPU.
        scan = (
            "associative"
            if (data.n_x + data.n_u <= 24 and xb.shape[0] < 1024)
            else "sequential"
        )

    def _one(dd, x, yx, yu):
        if mode == "eps":
            return _solve_one_eps(
                dd, x, yx, yu, n_iters, scan, eps_g, eps_V, check_every,
                restart, unroll,
            )
        return _solve_one(dd, x, yx, yu, n_iters, scan, restart, unroll)

    if q_lin is not None or c is not None:
        # fold the runtime parameters into per-solve effective constants
        # (the same algebra build_stagewise runs offline for build-time
        # c/x_ref, now batched on device): dtl_k = Ptilde_{k+1} c_k,
        # qoff_k += E_{k+1}' dtl_{k+1} + q_lin_k. The inner solvers see a
        # per-example StagewiseData via dataclasses.replace under vmap.
        n = data.n_x
        bt = lambda a: jnp.broadcast_to(
            jnp.asarray(a, dtype=data.hx.dtype), (*batch_shape, N, n)
        ).reshape((B, N, n))
        ce = bt(c) if c is not None else jnp.zeros((B, N, n), data.hx.dtype)
        qe = (
            bt(q_lin)
            if q_lin is not None
            else jnp.zeros((B, N, n), data.hx.dtype)
        )
        dtl_e = jnp.einsum("kij,bkj->bki", data.Pt, ce, precision=_HI)
        qoff_b = data.qoff[None] + qe
        qoff_b = qoff_b.at[:, :-1].add(
            jnp.einsum(
                "kji,bkj->bki", data.E[1:], dtl_e[:, 1:], precision=_HI
            )
        )
        c_b = data.c_seq[None] + ce
        dtl_b = data.dtl[None] + dtl_e

        def one(x, yx, yu, cf, df, qf):
            dd = dataclasses.replace(data, c_seq=cf, dtl=df, qoff=qf)
            return _one(dd, x, yx, yu)

        u, z, y, iters, residual, gap, conv = jax.vmap(one)(
            xb, y0x, y0u, c_b, dtl_b, qoff_b
        )
    else:
        one = lambda x, yx, yu: _one(data, x, yx, yu)
        u, z, y, iters, residual, gap, conv = jax.vmap(one)(xb, y0x, y0u)

    rs = lambda a: a.reshape((*batch_shape, *a.shape[1:]))
    return SolveResult(
        u=rs(u),
        z=rs(z),
        y=rs(y),
        iterations=rs(iters),
        residual=rs(residual),
        gap=rs(gap),
        converged=rs(conv),
    )


def stack_stagewise(datas) -> StagewiseData:
    """Stack same-shape ``StagewiseData`` builds along a leading plant
    axis (the stage-wise twin of ``solver.multi.stack_data``): every
    array leaf gains a leading P dimension (including the per-plant
    Lipschitz constants), meta fields must agree. Consumed by
    ``solve_stagewise_multi`` — B plants with DIFFERENT dynamics solved
    in one vmapped device call (the O(N) analogue of the reference's
    per-dataset host loop, ``main.cu:104-108``)."""
    d0 = datas[0]
    for d in datas[1:]:
        if (d.n_x, d.n_u, d.horizon, d.m_x, d.m_u, d.max_iters) != (
            d0.n_x, d0.n_u, d0.horizon, d0.m_x, d0.m_u, d0.max_iters
        ):
            raise ValueError(
                "stack_stagewise needs identical shapes: "
                f"{d.name} vs {d0.name}")
    leaves0, treedef = jax.tree_util.tree_flatten(d0)
    stacked = [
        jnp.stack([jax.tree_util.tree_leaves(d)[i] for d in datas])
        for i in range(len(leaves0))
    ]
    return jax.tree_util.tree_unflatten(treedef, stacked)


def solve_stagewise_multi(
    data: StagewiseData,
    x0: jax.Array,
    iterations: Optional[int] = None,
    y0: Optional[jax.Array] = None,
    scan: str = "auto",
    mode: str = "fixed",
    eps_g: float = 1e-6,
    eps_V: float = 1e-6,
    check_every: int = 10,
    restart: bool = False,
    config=None,
) -> SolveResult:
    """Solve P independent stage-wise problems (different dynamics/costs,
    one ``stack_stagewise`` build) in one device call.

    ``x0`` is (P, n_x) — one state per plant — or (P, B, n_x) for an
    inner scenario batch per plant. ``y0`` broadcastable to
    (P[, B], N, m_x + m_u). Runs the XLA stage-wise executors; ``scan``
    routing follows ``solve_stagewise`` with the per-plant batch size."""
    if config is not None:
        iterations = config.iterations
        mode = config.mode
        eps_g, eps_V = config.eps_g, config.eps_V
        check_every = config.check_every
        restart = config.restart
    if scan not in ("auto", "sequential", "associative"):
        raise ValueError(f"bad scan: {scan!r}")
    n_iters = int(iterations) if iterations is not None else data.max_iters
    x0 = jnp.asarray(x0)
    P = x0.shape[0]
    inner = x0.shape[1:-1]
    # NOTE: the m_x/m_u properties read Gx.shape[0], which is the PLANT
    # axis on stacked data — index from the trailing (row, col) dims
    N = data.horizon
    m_x, m_u = data.Gx.shape[-2], data.Gu.shape[-2]
    xb = x0.reshape((P, -1, data.n_x))
    B_in = xb.shape[1]
    if y0 is None:
        y0x = jnp.zeros((P, B_in, N, m_x), dtype=data.hx.dtype)
        y0u = jnp.zeros((P, B_in, N, m_u), dtype=data.hu.dtype)
    else:
        y0 = jnp.broadcast_to(
            jnp.asarray(y0, dtype=data.hx.dtype),
            (P, *inner, N, m_x + m_u),
        ).reshape((P, B_in, N, m_x + m_u))
        y0x, y0u = y0[..., :m_x], y0[..., m_x:]
    if scan == "auto":
        scan = (
            "associative"
            if (data.n_x + data.n_u <= 24 and B_in < 1024)
            else "sequential"
        )

    def one(dd, x, yx, yu):
        if mode == "eps":
            return _solve_one_eps(
                dd, x, yx, yu, n_iters, scan, eps_g, eps_V, check_every,
                restart, 1,
            )
        return _solve_one(dd, x, yx, yu, n_iters, scan, restart, 1)

    inner_v = jax.vmap(one, in_axes=(None, 0, 0, 0))
    u, z, y, iters, residual, gap, conv = jax.vmap(inner_v)(
        data, xb, y0x, y0u
    )
    rs = lambda a: a.reshape((P, *inner, *a.shape[2:]))
    return SolveResult(
        u=rs(u), z=rs(z), y=rs(y), iterations=rs(iters),
        residual=rs(residual), gap=rs(gap), converged=rs(conv),
    )


# Module-level jitted solve entries for stateful serving (controller /
# SQP): an UN-jitted solve_stagewise re-traces the 2N-step scan on every
# call, which costs more than the solve at serving shapes. `data` rides as a
# pytree ARGUMENT (constant shapes -> one trace), `config` is static
# (hashable frozen dataclass, same pattern as core.solve_batch).
@functools.partial(jax.jit, static_argnames=("config",))
def _jit_solve_cold(data: StagewiseData, x0: jax.Array, config):
    return solve_stagewise(data, x0, config=config)


@functools.partial(jax.jit, static_argnames=("config",))
def _jit_solve_warm(data: StagewiseData, x0: jax.Array, y0: jax.Array,
                    config):
    return solve_stagewise(data, x0, y0=y0, config=config)


def solve_stagewise_jit(data, x0, y0=None, config=None):
    """Jit-cached ``solve_stagewise`` for repeated same-shape calls.

    The serving entry: one trace per (shapes, config), then pure device
    execution. ``config`` must be a ``SolverConfig`` (or None for the
    defaults); per-call kwargs beyond ``y0`` want the functional
    ``solve_stagewise`` under your own ``jax.jit``."""
    from tpu_gpad.solver import SolverConfig

    config = config or SolverConfig()
    if y0 is None:
        return _jit_solve_cold(data, x0, config)
    return _jit_solve_warm(data, x0, y0, config)


class StagewiseController:
    """Stateful long-horizon MPC controller on the stage-wise engine:
    build once, then ``step(x) -> u`` with dual warm starts.

    The stage-wise twin of ``closed_loop.Controller`` (which condenses):
    for horizons past the condensation wall this serves the same
    embedded-MPC contract with O(N) data. Consecutive MPC QPs differ only
    in x0, so the previous sample's stage-packed dual is the right
    initializer.

    ``step`` accepts one state (n_x,) or a batch (B, n_x) of independent
    plants and returns the first move(s) as float32 NumPy. ``reset()``
    drops the warm start on a plant/setpoint discontinuity.
    """

    def __init__(
        self,
        problem: LinearMPCProblem,
        iterations: int = 100,
        config=None,
        warm_start: bool = True,
        L: Optional[float] = None,
        schedule: str = "paper",
    ):
        from tpu_gpad.solver import SolverConfig

        if config is None:
            config = SolverConfig(iterations=iterations)
        if config.iterations is None:
            config = dataclasses.replace(config, iterations=iterations)
        self.problem = problem
        self.data = build_stagewise(
            problem, iterations=config.iterations, L=L, schedule=schedule
        )
        self.config = config
        self.warm_start = warm_start
        self._y = None
        self.last_result = None

    def reset(self) -> None:
        self._y = None

    def step(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        single = x.ndim == 1
        xb = x[None, :] if single else x
        y0 = self._y if self.warm_start else None
        if y0 is not None and y0.shape[: xb.ndim - 1] != xb.shape[:-1]:
            # batch shape changed between steps: the stored dual neither
            # broadcasts (larger -> smaller) nor should it (a (1, N, m)
            # dual silently warm-starting ALL plants of a larger batch
            # from plant 0's dual) — drop it, same documented behavior as
            # closed_loop.Controller
            y0 = None
            self._y = None
        res = solve_stagewise_jit(
            self.data, jnp.asarray(xb), y0=y0, config=self.config
        )
        if self.warm_start:
            self._y = res.y
        self.last_result = res
        u = np.asarray(res.u, dtype=np.float32)
        return u[0] if single else u

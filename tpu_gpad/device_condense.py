"""Device-side (jittable) LTV condensation + dualization.

The host ``condense``/``dualize`` pair runs float64 NumPy — right for
offline problem setup, wrong for the NMPC inner loop, where every SQP
pass re-condenses the successive linearization (``nonlinear.NMPC``): the
(A_k, B_k, c_k) stacks live on device (they came out of ``jax.jacfwd``),
get pulled to host, condensed, and shipped back. This module rebuilds the
same algebra as pure JAX ops on TRACED inputs, so

    rollout -> linearize -> condense -> dualize -> GPAD solve

fuses into ONE jitted device program per SQP pass (and ONE vmapped
program for B scenarios) — no host round-trip, no float64 detour.

Scope (the NMPC fast path): tracking or preview cost, constant or
per-stage Q/R weights, input boxes (required — they give the paired
[P; -P] stack and the flat identity block), optional state boxes
(constant or per-stage, e.g. tube-tightened), input rate (slew) limits
with ``u_prev`` as a trailing parameter, per-stage input couplings
``K_u u_k = 0``, per-stage affine offsets ``c``. MULTI-SCENARIO robust
stacks (shared-first-move selector over per-scenario models) get the
same treatment via ``dualize_scenario_device`` — the device twin of
``robust.scenario_qp`` powering ``RobustNMPC(device_condense=True)``.
General polytopes (``H_x``/``H_u``) enter the paired stack with an
inert minus side (``types.PAD_BIG``), and SOFT state boxes
(``soft_state``) use the slack-free dual-damping formulation
(``GPADData.soft_damp``) — see ``dualize_ltv_device``.

Numerics: everything is fp32 on the device. The two linear solves against H use
Cholesky + one step of iterative refinement, and the Lipschitz constant
comes from a fixed-iteration power method on the half-stack dual Hessian
with a 1% safety margin (L only needs to be an UPPER bound on
lambda_max; a tiny overestimate costs <1% extra iterations, an
underestimate breaks convergence). Accuracy vs the float64 host path is
pinned by tests/test_device_condense.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_gpad.schedule import momentum_schedule
from tpu_gpad.types import GPADData, PAD_BIG


def _highest_matmuls(fn):
    """Trace ``fn`` under fp32-highest matmul precision: DEFAULT precision
    may run reduced-precision passes (TF32 on a GPU, ~1e-3 relative), which
    would corrupt the condensed operands (H, T, S, the dual Hessian) —
    condensation accuracy bounds the solution accuracy, so it always runs
    full fp32. The matrices involved are tiny."""
    import functools as _ft

    @_ft.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


@_highest_matmuls
def prediction_matrices_device(A: jax.Array, B: jax.Array):
    """Jittable ``prediction_matrices_ltv``: stacked (N, n_x, n_x) /
    (N, n_x, n_u) -> dense T (N*n_x, n_x), S (N*n_x, N*n_u).

    N is static (Python loop unrolled into the trace); the per-block
    matmuls are tiny, so clarity beats a scan here."""
    N, n_x, _ = A.shape
    n_u = B.shape[-1]
    T_blocks = []
    S_rows = []
    phi = jnp.eye(n_x, dtype=A.dtype)
    # row i uses Phi(i, j) B_{j-1}; build each row by back-accumulation
    for i in range(1, N + 1):
        phi = A[i - 1] @ phi
        T_blocks.append(phi)
        acc = jnp.eye(n_x, dtype=A.dtype)
        row = [None] * N
        for j in range(i, 0, -1):
            row[j - 1] = acc @ B[j - 1]
            acc = acc @ A[j - 1]
        zero = jnp.zeros((n_x, n_u), dtype=A.dtype)
        S_rows.append(jnp.concatenate(
            [row[j] if row[j] is not None else zero for j in range(N)], axis=1
        ))
    return jnp.concatenate(T_blocks, axis=0), jnp.concatenate(S_rows, axis=0)


def _chol_solve_refined(H: jax.Array, Bmat: jax.Array) -> jax.Array:
    """fp32 ``H^-1 Bmat`` via Cholesky plus one iterative-refinement step
    (recovers most of the fp32 factorization error for the mildly
    conditioned H of successive linearizations)."""
    chol = jnp.linalg.cholesky(H)
    solve = partial(jax.scipy.linalg.cho_solve, (chol, True))
    X = solve(Bmat)
    return X + solve(Bmat - H @ X)


def _power_lmax(M: jax.Array, iters: int = 96) -> jax.Array:
    """lambda_max of a symmetric PSD M: power method + Rayleigh quotient.

    The start vector is a FIXED pseudo-random host constant (per shape),
    never the all-ones vector: symmetric plants routinely have their
    dominant dual mode orthogonal to 1 (e.g. identical-cell balancing,
    whose top mode is mean-free), and a start vector orthogonal to the
    dominant eigenvector converges to a sub-dominant eigenvalue. The
    Rayleigh quotient always UNDERestimates lambda_max, hence the
    explicit safety margin applied by the caller."""
    m = M.shape[0]
    v0 = np.random.default_rng(0).standard_normal(m).astype(np.float32)
    v0 = jnp.asarray(v0 / np.linalg.norm(v0), dtype=M.dtype)

    def body(_, v):
        w = M @ v
        return w / jnp.linalg.norm(w)

    v = jax.lax.fori_loop(0, iters, body, v0)
    Mv = M @ v
    lam = v @ Mv  # Rayleigh quotient of the converged iterate
    # relative eigen-residual ||Mv - lam v|| / lam: ~0 when the iterate has
    # converged to the dominant eigenvector; O(1) when a small eigengap
    # left it short (in which case lam may badly underestimate lambda_max)
    resid = jnp.linalg.norm(Mv - lam * v) / jnp.maximum(lam, 1e-30)
    return lam, resid


def _stage_box(v, N: int, n: int, what: str) -> jax.Array:
    """Validate constant (n,) or per-stage (N, n) box bounds and ravel to
    the stage-major (N*n,) layout the paired stacks use."""
    arr = np.asarray(v, np.float32)
    if arr.ndim == 1:
        arr = np.tile(arr, (N, 1))
    if arr.shape != (N, n):
        raise ValueError(
            f"{what} must be ({n},) or ({N},{n}); got {np.asarray(v).shape}"
        )
    return jnp.asarray(arr.ravel())


@_highest_matmuls
def dualize_ltv_device(
    A: jax.Array,
    B: jax.Array,
    c: jax.Array,
    Q: np.ndarray,
    R: np.ndarray,
    u_min: np.ndarray,
    u_max: np.ndarray,
    iterations: int,
    Q_terminal: Optional[np.ndarray] = None,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    du_min: Optional[np.ndarray] = None,
    du_max: Optional[np.ndarray] = None,
    K_u: Optional[np.ndarray] = None,
    H_x: Optional[np.ndarray] = None,
    h_x: Optional[np.ndarray] = None,
    H_u: Optional[np.ndarray] = None,
    h_u: Optional[np.ndarray] = None,
    soft_state: Optional[float] = None,
    preview: bool = False,
    schedule: str = "paper",
    power_iters: int = 64,
    name: str = "ltv_device",
) -> GPADData:
    """Condense + dualize a tracking LTV MPC problem entirely on device.

    ``A``/``B``/``c`` are traced stacks (N, n_x, n_x) / (N, n_x, n_u) /
    (N, n_x) — e.g. straight from ``nonlinear.linearize``; the cost and
    box constants are static NumPy. Returns a ``GPADData`` whose array
    leaves are traced device values in the PAIRED, FLAT layout — rows are
    [state-box | K_u coupling | rate (when du bounds given) | input-box
    identity], with the identity block last — bit-compatible with
    everything downstream (``solve_batch``, all engines, warm starts).
    ``K_u`` adds the per-stage input coupling ``K_u u_k = 0`` as the
    +/- pair (the battery charge-conservation class, ``gpad.m:44``).

    Parameter layout matches ``condense(tracking=True)`` /
    ``tracking="preview"``: ``p = [x0; r]`` (r of n_x or N*n_x entries),
    plus ``u_prev`` (n_u trailing entries) when slew limits
    ``du_min``/``du_max`` are given.

    Semantics match the host pipeline
    ``dualize(condense(problem, tracking=...), paired=True)`` with
    ``lipschitz="spectral_dual"`` — up to fp32 vs float64 arithmetic and
    the power-method L (>= lambda_max by a 1% margin instead of exact).

    ``H_x``/``h_x`` and ``H_u``/``h_u`` add general polytope rows
    (``H_x x_k <= h_x`` for k=1..N, ``H_u u_k <= h_u`` for k=0..N-1;
    h of shape (q,) or per-stage (N, q)). One-sided rows break the host
    path's [P; -P] pairing, so there they fall back to the DENSE dual
    layout — here they enter the paired stack with an INERT minus side
    (RHS ``types.PAD_BIG``, zero parameter columns): the minus dual stays
    exactly 0 every iteration, the flat identity block survives, and the
    fused paired kernels keep working. Cost: the power-method L counts
    the phantom side (a safe overestimate, <= 2x on polytope-dominated
    stacks).

    ``soft_state`` softens the state-box rows with quadratic slack
    penalties of weight ``soft_state`` — same optimum as the host slack
    formulation (``condense(soft_state=...)``), but slack-free: instead
    of 2 N n_x slack variables and rows, the dual of a quadratic penalty
    is a per-row damping of the projected-gradient update
    (``GPADData.soft_damp``; L gains +1/rho). No decision-space growth,
    no layout change. Fixed-iteration mode (NMPC's mode) and eps mode
    both honor it via the XLA engine.
    """
    N, n_x, _ = A.shape
    n_u = B.shape[-1]
    n_z = N * n_u
    f32 = jnp.float32
    A = jnp.asarray(A, f32)
    B = jnp.asarray(B, f32)
    c = jnp.asarray(c, f32)
    have_xbox = x_min is not None or x_max is not None
    if (x_min is None) != (x_max is None):
        raise ValueError("device path needs both x_min and x_max (or neither)")
    if u_min is None or u_max is None:
        raise ValueError("device path needs input boxes (they form the "
                         "paired stack's identity block)")

    T, S = prediction_matrices_device(A, B)  # (Nn_x, n_x), (Nn_x, n_z)

    # s_off: cumulative affine offset, off_{k} = A_{k-1} off_{k-1} + c_{k-1}
    def off_body(off, Ac):
        A_k, c_k = Ac
        off = A_k @ off + c_k
        return off, off

    _, offs = jax.lax.scan(off_body, jnp.zeros(n_x, f32), (A, c))
    s_off = offs.reshape(N * n_x)

    # Qbar S / Qbar T / Qbar s_off via per-block products (Qbar is block
    # diagonal; stage N uses Q_terminal when given). Q/R accept constant
    # (n, n) or stacked per-stage (N, n, n) weights, like the host path.
    # Q/R may be TRACED (e.g. learned weights differentiated through the
    # solve via diff.make_data_differentiable_solver) — keep everything in
    # jnp; shapes stay static under tracing so the checks still fire
    Q_arr = jnp.asarray(Q, f32)
    if Q_arr.shape not in ((n_x, n_x), (N, n_x, n_x)):
        raise ValueError(f"Q must be ({n_x},{n_x}) or ({N},{n_x},{n_x}); "
                         f"got {Q_arr.shape}")
    Qs = Q_arr if Q_arr.ndim == 3 else jnp.broadcast_to(
        Q_arr, (N, n_x, n_x)
    )
    if Q_terminal is not None:
        Qs = Qs.at[-1].set(jnp.asarray(Q_terminal, f32))

    def qbar(M):  # (N*n_x, k) -> Qbar @ M
        M3 = M.reshape(N, n_x, -1)
        return jnp.einsum("kij,kjl->kil", Qs, M3).reshape(N * n_x, -1)

    R_arr = jnp.asarray(R, f32)
    if R_arr.shape not in ((n_u, n_u), (N, n_u, n_u)):
        raise ValueError(f"R must be ({n_u},{n_u}) or ({N},{n_u},{n_u}); "
                         f"got {R_arr.shape}")
    R3 = R_arr if R_arr.ndim == 3 else jnp.broadcast_to(
        R_arr, (N, n_u, n_u)
    )
    Rbar = jax.scipy.linalg.block_diag(*[R3[k] for k in range(N)])
    QbarS = qbar(S)
    H = S.T @ QbarS + Rbar
    H = 0.5 * (H + H.T)
    F_x0 = T.T @ QbarS  # (n_x, n_z)
    if preview:
        F_r = -QbarS  # (N*n_x, n_z)
    else:
        ones_kron = jnp.tile(jnp.eye(n_x, dtype=f32), (N, 1))  # (N n_x, n_x)
        F_r = -(ones_kron.T @ QbarS)  # (n_x, n_z)
    F = jnp.concatenate([F_x0, F_r], axis=0)  # (n_p, n_z)
    g_vec = S.T @ qbar(s_off[:, None])[:, 0]  # S' Qbar s_off

    # paired half stack in FLAT order: structured rows first (state boxes,
    # then rate rows), the input-box identity block last — a valid
    # dualize-flat layout constructed directly
    have_rate = du_min is not None or du_max is not None
    if (du_min is None) != (du_max is None):
        raise ValueError("device path needs both du_min and du_max "
                         "(or neither)")
    ref_dim = N * n_x if preview else n_x
    n_p = n_x + ref_dim + (n_u if have_rate else 0)
    I_z = jnp.eye(n_z, dtype=f32)
    zeros_pz = jnp.zeros((n_z, n_p), f32)

    def stage_box(v, n, what):
        return _stage_box(v, N, n, what)

    u_max_t = stage_box(u_max, n_u, "u_max")
    u_min_t = stage_box(u_min, n_u, "u_min")
    P_rows, b0p_rows, b0m_rows, Ep_rows, Em_rows = [], [], [], [], []
    soft_rows = []  # per-block row counts + softness, for the damp mask
    if soft_state is not None:
        if soft_state <= 0:
            raise ValueError("soft_state penalty weight must be positive")
        if not have_xbox:
            raise ValueError("soft_state set but the problem has no state box")
    if have_xbox:
        x_max_t = stage_box(x_max, n_x, "x_max") - s_off
        x_min_t = stage_box(x_min, n_x, "x_min") - s_off
        zeros_rest = jnp.zeros((N * n_x, n_p - n_x), f32)
        P_rows.append(S)  # + rows: S z <= xmax' - T x0
        b0p_rows.append(x_max_t)
        b0m_rows.append(-x_min_t)
        Ep_rows.append(jnp.concatenate([-T, zeros_rest], axis=1))
        Em_rows.append(jnp.concatenate([T, zeros_rest], axis=1))
        soft_rows.append((N * n_x, soft_state is not None))
    if K_u is not None:
        # per-stage input coupling K_u u_k = 0 as the +/- pair (the battery
        # charge-conservation class, gpad.m:44,84-85): structured rows with
        # zero RHS and no parameter dependence
        K_arr = np.asarray(K_u, np.float32)
        if K_arr.ndim != 2 or K_arr.shape[1] != n_u:
            raise ValueError(f"K_u must be (n_c, {n_u}); got {K_arr.shape}")
        Kbar = np.kron(np.eye(N, dtype=np.float32), K_arr)
        P_rows.append(jnp.asarray(Kbar))
        zero_c = jnp.zeros(Kbar.shape[0], f32)
        b0p_rows.append(zero_c)
        b0m_rows.append(zero_c)
        zero_E = jnp.zeros((Kbar.shape[0], n_p), f32)
        Ep_rows.append(zero_E)
        Em_rows.append(zero_E)
        soft_rows.append((Kbar.shape[0], False))
    if have_rate:
        # slew rows: du_min <= u_k - u_{k-1} <= du_max with u_{-1} = the
        # previously APPLIED move, a trailing parameter (condense's rate
        # layout). Dz is the block difference map; only the first n_u rows
        # see u_prev (+I on the + side, -I on the -).
        du_max_a = np.asarray(du_max, np.float32)
        du_min_a = np.asarray(du_min, np.float32)
        if du_max_a.shape != (n_u,) or du_min_a.shape != (n_u,):
            raise ValueError(f"du bounds must be ({n_u},) on the device path")
        Dz = np.eye(n_z, dtype=np.float32)
        for k in range(1, N):
            Dz[k * n_u : (k + 1) * n_u, (k - 1) * n_u : k * n_u] = -np.eye(n_u)
        u_prev_cols = np.zeros((n_z, n_u), np.float32)
        u_prev_cols[:n_u] = np.eye(n_u)
        E_rate_p = np.zeros((n_z, n_p), np.float32)
        E_rate_p[:, n_x + ref_dim :] = u_prev_cols
        P_rows.append(jnp.asarray(Dz))
        b0p_rows.append(jnp.asarray(np.tile(du_max_a, N)))
        b0m_rows.append(jnp.asarray(-np.tile(du_min_a, N)))
        Ep_rows.append(jnp.asarray(E_rate_p))
        Em_rows.append(jnp.asarray(-E_rate_p))
        soft_rows.append((n_z, False))
    # general polytope rows (one-sided): paired with an INERT minus side —
    # RHS PAD_BIG, zero parameter columns — so the minus dual projects to
    # exactly 0 every iteration (see the docstring)
    if (H_x is None) != (h_x is None):
        raise ValueError("H_x and h_x must be passed together")
    if (H_u is None) != (h_u is None):
        raise ValueError("H_u and h_u must be passed together")
    if H_x is not None:
        Hx = np.asarray(H_x, np.float32)
        if Hx.ndim != 2 or Hx.shape[1] != n_x:
            raise ValueError(f"H_x must be (q_x, {n_x}); got {Hx.shape}")
        q_x = Hx.shape[0]
        Hbar_x = jnp.asarray(np.kron(np.eye(N, dtype=np.float32), Hx))
        hx_t = _stage_box(h_x, N, q_x, "h_x") - Hbar_x @ s_off
        zeros_rest_x = jnp.zeros((N * q_x, n_p - n_x), f32)
        P_rows.append(Hbar_x @ S)  # Hbar (T x0 + S z + off) <= hx
        b0p_rows.append(hx_t)
        b0m_rows.append(jnp.full(N * q_x, PAD_BIG, f32))
        Ep_rows.append(jnp.concatenate([-(Hbar_x @ T), zeros_rest_x], axis=1))
        Em_rows.append(jnp.zeros((N * q_x, n_p), f32))
        soft_rows.append((N * q_x, False))
    if H_u is not None:
        Hu = np.asarray(H_u, np.float32)
        if Hu.ndim != 2 or Hu.shape[1] != n_u:
            raise ValueError(f"H_u must be (q_u, {n_u}); got {Hu.shape}")
        q_u = Hu.shape[0]
        P_rows.append(jnp.asarray(np.kron(np.eye(N, dtype=np.float32), Hu)))
        b0p_rows.append(_stage_box(h_u, N, q_u, "h_u"))
        b0m_rows.append(jnp.full(N * q_u, PAD_BIG, f32))
        Ep_rows.append(jnp.zeros((N * q_u, n_p), f32))
        Em_rows.append(jnp.zeros((N * q_u, n_p), f32))
        soft_rows.append((N * q_u, False))
    # the input-box identity block, always last (the flat contract)
    P_rows.append(I_z)
    b0p_rows.append(u_max_t)
    b0m_rows.append(-u_min_t)
    Ep_rows.append(zeros_pz)
    Em_rows.append(zeros_pz)
    soft_rows.append((n_z, False))

    P = jnp.concatenate(P_rows, axis=0)  # (m_h, n_z)
    b0_plus = jnp.concatenate(b0p_rows)
    b0_minus = jnp.concatenate(b0m_rows)
    E_plus = jnp.concatenate(Ep_rows, axis=0)
    E_minus = jnp.concatenate(Em_rows, axis=0)
    if have_rate:
        # the cost never sees u_prev: zero parameter rows in F
        F = jnp.concatenate([F, jnp.zeros((n_u, n_z), f32)], axis=0)

    soft_inv_rho = None
    if soft_state is not None:
        soft_inv_rho = jnp.asarray(np.concatenate(
            [np.full(n, 1.0 / soft_state if is_soft else 0.0, np.float32)
             for n, is_soft in soft_rows]
        ))

    return _finish_dualize(
        P, b0_plus, b0_minus, E_plus, E_minus, H, F, g_vec,
        n_u=n_u, n_p=n_p, horizon=N, iterations=iterations,
        schedule=schedule, power_iters=power_iters, name=name,
        soft_inv_rho=soft_inv_rho,
    )


def _finish_dualize(
    P, b0_plus, b0_minus, E_plus, E_minus, H, F, g_vec, *,
    n_u: int, n_p: int, horizon: int, iterations: int,
    schedule: str, power_iters: int, name: str,
    soft_inv_rho=None,
) -> GPADData:
    """Dualize a paired flat half stack (shared by the LTV and scenario
    device paths): dual Hessian, safe Lipschitz bound, GPAD operands.

    ``P`` is the (m_h, n_zt) half stack with the identity block LAST
    (n_struct = m_h - n_zt rows of structure before it)."""
    n_zt = P.shape[1]
    n_struct = int(P.shape[0] - n_zt)

    Hinv_Pt = _chol_solve_refined(H, P.T)  # (n_zt, m_h)
    Hd_h = P @ Hinv_Pt  # half-stack dual Hessian P H^-1 P'
    Hd_h = 0.5 * (Hd_h + Hd_h.T)
    # full-stack G = [P; -P] doubles lambda_max. The Rayleigh-quotient
    # estimate lower-bounds lambda_max, so it is only trusted when the
    # power iterate has actually converged (eigen-residual small); a small
    # eigengap can leave the iterate short after the fixed budget, and an
    # underestimated L breaks the GPAD convergence guarantee. On poor
    # convergence fall back to the CERTIFIED max-abs-row-sum bound
    # (||.||_inf >= lambda_max for symmetric PSD) — conservative (more
    # iterations to a given accuracy) but never invalid. The 5% margin on
    # the converged estimate costs ~2.5% extra iterations.
    lam, lam_resid = _power_lmax(Hd_h, power_iters)
    est = 1.05 * (2.0 * lam)
    cert = 2.0 * jnp.max(jnp.sum(jnp.abs(Hd_h), axis=1))  # ||.||_inf, symmetric
    L = jnp.where(lam_resid < 0.02, jnp.minimum(est, cert), cert)
    if soft_inv_rho is not None:
        # the regularized dual Hessian is G H^-1 G' + diag(1/rho_i):
        # lambda_max grows by at most max_i 1/rho_i (0 on hard rows)
        L = L + jnp.max(soft_inv_rho)

    MG_T = Hinv_Pt.T  # (m_h, n_zt)
    GL_T = P.T / L
    D = Hd_h / L

    gP_map = _chol_solve_refined(H, F.T).T  # (n_p, n_zt)
    gP_const = _chol_solve_refined(H, g_vec[:, None])[:, 0]
    pD_map = jnp.stack([-E_plus.T / L, -E_minus.T / L], axis=1)  # (n_p, 2, m_h)
    pD_const = jnp.stack([-b0_plus / L, -b0_minus / L], axis=0)  # (2, m_h)

    theta, beta = momentum_schedule(iterations, schedule)
    soft_damp = None
    if soft_inv_rho is not None:
        soft_damp = soft_inv_rho / L
    return GPADData(
        MG_T=MG_T,
        GL_T=GL_T,
        gP_map=gP_map,
        gP_const=gP_const,
        pD_map=pD_map,
        pD_const=pD_const,
        soft_damp=soft_damp,
        D=D,
        L=L.astype(jnp.float32),
        theta=jnp.asarray(theta),
        beta=jnp.asarray(beta),
        n_u=n_u,
        n_x=n_p,
        horizon=horizon,
        name=name,
        paired=True,
        n_struct=n_struct,
    )


@_highest_matmuls
def dualize_scenario_device(
    A: jax.Array,
    B: jax.Array,
    c: jax.Array,
    Q: np.ndarray,
    R: np.ndarray,
    u_min: np.ndarray,
    u_max: np.ndarray,
    iterations: int,
    weights=None,
    Q_terminal: Optional[np.ndarray] = None,
    x_min: Optional[np.ndarray] = None,
    x_max: Optional[np.ndarray] = None,
    soft_state: Optional[float] = None,
    preview: bool = False,
    schedule: str = "paper",
    power_iters: int = 64,
    name: str = "scenario_device",
) -> GPADData:
    """Condense + dualize a MULTI-SCENARIO (robust) LTV stack on device.

    The device twin of ``robust.scenario_qp`` composed with ``condense``/
    ``dualize``: ``A``/``B``/``c`` are traced
    per-scenario stacks of shape (S, N, n_x, n_x) / (S, N, n_x, n_u) /
    (S, N, n_x) — e.g. one successive linearization per model realization —
    and the result is the shared-first-move scenario QP's GPADData, built
    without any host round-trip so ``RobustNMPC(device_condense=True)``
    runs each SQP pass as one fused device program (the same per-solve
    recondensation cost the nominal path eliminated; cf. the reference
    recomputing its dual constants per solve, ``acceldualgrad.m:20-23``).

    Decision layout (robust.scenario_qp's non-anticipativity selector with
    ``n_shared = n_u``): ``z~ = [u_0; v^1; ...; v^S]`` with per-scenario
    tails ``v^s`` of ``(N-1) n_u`` entries. Cost/boxes are SHARED across
    scenarios (per-stage (N, n)-shaped boxes accepted — e.g. tube-tightened
    stacks); ``weights`` are the scenario probabilities (default uniform).
    Unlike the host path no row dedupe is needed: the identity block over
    z~ covers every decision variable exactly once by construction, so the
    stack is born flat (struct rows = S per-scenario state boxes, identity
    block last). Parameter layout: ``p = [x0; r]`` like
    ``condense(tracking=...)``. ``SolveResult.u`` is the shared first move.
    """
    S, N, n_x, _ = A.shape
    n_u = B.shape[-1]
    n_z = N * n_u
    tail = n_z - n_u
    n_tilde = n_u + S * tail
    f32 = jnp.float32
    A = jnp.asarray(A, f32)
    B = jnp.asarray(B, f32)
    c = jnp.asarray(c, f32)
    if u_min is None or u_max is None:
        raise ValueError("device path needs input boxes (they form the "
                         "paired stack's identity block)")
    if (x_min is None) != (x_max is None):
        raise ValueError("device path needs both x_min and x_max (or neither)")
    have_xbox = x_min is not None
    if weights is None:
        w = np.full(S, 1.0 / S, dtype=np.float32)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (S,) or (w <= 0).any():
            raise ValueError("weights must be S positive floats")
        w = (w / w.sum()).astype(np.float32)

    # per-scenario prediction operators + cumulative affine offsets
    Ts, Ss = jax.vmap(prediction_matrices_device)(A, B)  # (S,Nn_x,n_x/n_z)

    def offsets(A_s, c_s):
        def body(off, Ac):
            A_k, c_k = Ac
            off = A_k @ off + c_k
            return off, off

        _, offs = jax.lax.scan(body, jnp.zeros(n_x, f32), (A_s, c_s))
        return offs.reshape(N * n_x)

    s_offs = jax.vmap(offsets)(A, c)  # (S, N*n_x)

    # shared stage weights (Qbar block diagonal, terminal override) + Rbar;
    # traced-weight friendly, same as dualize_ltv_device
    Q_arr = jnp.asarray(Q, f32)
    if Q_arr.shape not in ((n_x, n_x), (N, n_x, n_x)):
        raise ValueError(f"Q must be ({n_x},{n_x}) or ({N},{n_x},{n_x}); "
                         f"got {Q_arr.shape}")
    Qs = Q_arr if Q_arr.ndim == 3 else jnp.broadcast_to(
        Q_arr, (N, n_x, n_x)
    )
    if Q_terminal is not None:
        Qs = Qs.at[-1].set(jnp.asarray(Q_terminal, f32))

    def qbar(M):  # (N*n_x, k) -> Qbar @ M
        M3 = M.reshape(N, n_x, -1)
        return jnp.einsum("kij,kjl->kil", Qs, M3).reshape(N * n_x, -1)

    R_arr = jnp.asarray(R, f32)
    if R_arr.shape not in ((n_u, n_u), (N, n_u, n_u)):
        raise ValueError(f"R must be ({n_u},{n_u}) or ({N},{n_u},{n_u}); "
                         f"got {R_arr.shape}")
    R3 = R_arr if R_arr.ndim == 3 else jnp.broadcast_to(
        R_arr, (N, n_u, n_u)
    )
    Rbar = jax.scipy.linalg.block_diag(*[R3[k] for k in range(N)])

    ref_dim = N * n_x if preview else n_x
    n_p = n_x + ref_dim
    ones_kron = jnp.tile(jnp.eye(n_x, dtype=f32), (N, 1))  # (N n_x, n_x)

    # stacked cost via the selector block structure: z~'s shared block
    # accumulates every scenario's u_0 coupling; each tail block is w_s
    # times that scenario's own blocks (robust.scenario_qp:97-108 on host)
    H = jnp.zeros((n_tilde, n_tilde), f32)
    F = jnp.zeros((n_p, n_tilde), f32)
    g_vec = jnp.zeros(n_tilde, f32)
    for s in range(S):
        QbarS = qbar(Ss[s])  # (N n_x, n_z)
        H_s = Ss[s].T @ QbarS + Rbar
        F_x0 = Ts[s].T @ QbarS  # (n_x, n_z)
        F_r = -QbarS if preview else -(ones_kron.T @ QbarS)
        F_s = jnp.concatenate([F_x0, F_r], axis=0)  # (n_p, n_z)
        g_s = Ss[s].T @ qbar(s_offs[s][:, None])[:, 0]
        off = n_u + s * tail
        sl = slice(off, off + tail)
        H = H.at[:n_u, :n_u].add(w[s] * H_s[:n_u, :n_u])
        H = H.at[:n_u, sl].set(w[s] * H_s[:n_u, n_u:])
        H = H.at[sl, :n_u].set(w[s] * H_s[n_u:, :n_u])
        H = H.at[sl, sl].set(w[s] * H_s[n_u:, n_u:])
        F = F.at[:, :n_u].add(w[s] * F_s[:, :n_u])
        F = F.at[:, sl].set(w[s] * F_s[:, n_u:])
        g_vec = g_vec.at[:n_u].add(w[s] * g_s[:n_u])
        g_vec = g_vec.at[sl].set(w[s] * g_s[n_u:])
    H = 0.5 * (H + H.T)

    # paired flat half stack: per-scenario state-box rows (structural),
    # then the z~ identity block LAST (born flat — no dedupe needed: each
    # decision variable has exactly one box row)
    P_rows, b0p_rows, b0m_rows, Ep_rows, Em_rows = [], [], [], [], []
    soft_blocks = []  # (rows, 1/rho_effective) per block, for soft_damp
    if soft_state is not None:
        if soft_state <= 0:
            raise ValueError("soft_state penalty weight must be positive")
        if not have_xbox:
            raise ValueError("soft_state set but the problem has no state box")
    if have_xbox:
        x_max_t = _stage_box(x_max, N, n_x, "x_max")
        x_min_t = _stage_box(x_min, N, n_x, "x_min")
        zeros_ref = jnp.zeros((N * n_x, ref_dim), f32)
        for s in range(S):
            off = n_u + s * tail
            row = jnp.zeros((N * n_x, n_tilde), f32)
            row = row.at[:, :n_u].set(Ss[s][:, :n_u])
            row = row.at[:, off : off + tail].set(Ss[s][:, n_u:])
            P_rows.append(row)
            b0p_rows.append(x_max_t - s_offs[s])
            b0m_rows.append(-(x_min_t - s_offs[s]))
            Ep_rows.append(jnp.concatenate([-Ts[s], zeros_ref], axis=1))
            Em_rows.append(jnp.concatenate([Ts[s], zeros_ref], axis=1))
            # host twin: scenario_qp scales scenario s's (softened) H by
            # w_s, so its slack penalty becomes w_s * rho — the damping
            # must use that scenario's EFFECTIVE rho
            soft_blocks.append((
                N * n_x,
                0.0 if soft_state is None else 1.0 / (w[s] * soft_state),
            ))
    u_max_t = _stage_box(u_max, N, n_u, "u_max")
    u_min_t = _stage_box(u_min, N, n_u, "u_min")
    # identity-block bounds on z~: stage-0 bounds once (the shared move),
    # stage 1..N-1 bounds repeated per scenario tail
    b0p_id = jnp.concatenate(
        [u_max_t[:n_u]] + [u_max_t[n_u:]] * S
    )
    b0m_id = jnp.concatenate(
        [-u_min_t[:n_u]] + [-u_min_t[n_u:]] * S
    )
    P_rows.append(jnp.eye(n_tilde, dtype=f32))
    b0p_rows.append(b0p_id)
    b0m_rows.append(b0m_id)
    zeros_id = jnp.zeros((n_tilde, n_p), f32)
    Ep_rows.append(zeros_id)
    Em_rows.append(zeros_id)
    soft_blocks.append((n_tilde, 0.0))

    soft_inv_rho = None
    if soft_state is not None:
        soft_inv_rho = jnp.asarray(np.concatenate(
            [np.full(n, v, np.float32) for n, v in soft_blocks]
        ))

    horizon = n_tilde // n_u if n_tilde % n_u == 0 else N
    return _finish_dualize(
        jnp.concatenate(P_rows, axis=0),
        jnp.concatenate(b0p_rows),
        jnp.concatenate(b0m_rows),
        jnp.concatenate(Ep_rows, axis=0),
        jnp.concatenate(Em_rows, axis=0),
        H,
        F,
        g_vec,
        n_u=n_u,
        n_p=n_p,
        horizon=horizon,
        iterations=iterations,
        schedule=schedule,
        power_iters=power_iters,
        name=name,
        soft_inv_rho=soft_inv_rho,
    )

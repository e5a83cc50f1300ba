"""Implicit differentiation through the GPAD solve (MPC as a layer).

The reference solves each QP and stops; nothing in its stack can answer
"how does u* move when the parameter moves?" — the object behind explicit
MPC gains, sensitivity analysis, and learning-based MPC (tuning costs or
references by gradient descent THROUGH the controller). In JAX this is
a first-class capability: differentiate the solver's *fixed point* instead
of unrolling its iterations, so the backward pass is one masked KKT solve
instead of 100+ rematerialized loop steps.

Math (standard parametric-QP sensitivity, e.g. OptNet/Fiacco): at the
solution of

    min_z 0.5 z'Hz + (F'p + g)'z   s.t.  G z <= b0 + E p

with active set A = {i : y*_i > 0} (strict complementarity), the
differentials satisfy

    H dz + G_A' dy_A = -F' dp
    G_A dz           =  E_A dp        (hard rows)
    G_A dz - dy_A/rho = E_A dp        (soft rows, quadratic penalty rho)

Eliminating dz gives a dual-space system in the *scaled* operands the
solver already stores (no H^-1, G, or E are ever materialized here):

    (M Dh M + diag(damp * m) + (I - M)) dy = M r dp

where Dh = G H^-1 G' / L  ==  ``data.D`` (paired) or ``MG_T @ GL_T``,
damp == ``data.soft_damp`` (exactly diag(1/rho)/L), and the rhs map is

    r(+rows) =  (pD_map[+] - gP_map @ GL_T)'      # = -(E+ + G H^-1 F')/L
    r(-rows) = (-pD_map[-] - gP_map @ GL_T)'      # paired minus side

Then dz = -MG_T' dy - gP_map' dp. In the paired [P; -P] layout the system
lives on the HALF stack via the signed dual ytilde = y+ - y- (at most one
side of a pair is active), so the per-scenario solve is (m_h, m_h). The
system matrix is symmetric, so the VJP reuses
it verbatim (one extra batched solve per backward pass).

Caveats (documented, not hidden): derivatives assume the solve converged
and the active set is strict (|y*| either 0 or clearly positive). Weakly
active constraints (y* ~ 0 AND G z* = b) make u*(p) nondifferentiable —
this module returns the one-sided derivative selected by the mask
threshold. Degenerate active sets (more than n_z active rows) violate
LICQ; pass ``ridge > 0`` to regularize the solve there.

No reference analogue (closest spiritual anchor: the per-solve parameter
maps of ``acceldualgrad.m:20-23``, which this module differentiates).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tpu_gpad.types import GPADData
from tpu_gpad.solver import core as _core


def _dual_hessian(data: GPADData) -> jax.Array:
    """Scaled dual Hessian G H^-1 G'/L on the stored (half-)stack."""
    if data.D is not None:
        return data.D
    return data.MG_T @ data.GL_T  # (S, S), dense or paired half stack


def _rhs_maps(data: GPADData):
    """(r_plus, r_minus) rhs maps, each (S, n_p); r_minus is None dense."""
    # gP_map (n_p, n_z) @ GL_T (n_z, S) = (G H^-1 F')'/L; transpose (S, n_p)
    cross = (data.gP_map @ data.GL_T).T
    if data.paired:
        r_plus = data.pD_map[:, 0, :].T - cross
        r_minus = -data.pD_map[:, 1, :].T - cross
        return r_plus, r_minus
    return data.pD_map.T - cross, None


def _solve_masked_system(data, m_b, ridge, Bmat, method="auto"):
    """Batched solve of the masked KKT system (SPD by construction:
    masked PSD dual Hessian + identity on inactive rows + nonnegative
    soft/ridge diagonal). ``Bmat`` is (B, S, K).

    Two paths; ``method="auto"`` takes Cholesky:

    - ``"chol"``: materialize the (B, S, S) system and Cholesky-solve —
      exact up to fp32 rounding.
    - ``"cg"``: matrix-free conjugate gradients against the SHARED (S, S)
      dual Hessian — every iteration is one (B*K, S) @ (S, S) matmul, the
      same design move as the solver itself. At most S + 8 iterations
      (exact-termination bound), each scenario stopping at a 1e-5
      relative residual, whatever else shares its batch.

    Measured on an H100 (PERF.md), a gradient through the solve costs
    1.58 vs 1.98 ms (battery n3 N10, B=4096), 10.6 vs 13.7 ms (N50,
    B=1024) and 20.4 vs 35.1 ms (30x30, B=64) with CG vs Cholesky; but
    against a float64 solve CG's gradient is off by up to 1.9e-4 of its
    largest component where Cholesky's is off by 1.4e-6 (CPU, N50 and
    30x30), so the default is the exact path and CG an opt-in.

    LICQ-degenerate active sets make the system singular — pass
    ``ridge > 0`` there (documented on every entry point)."""
    if method == "auto":
        method = "chol"
    Dh = _dual_hessian(data)
    diag = (1.0 - m_b) + ridge * m_b
    if data.soft_damp is not None:
        diag = diag + data.soft_damp * m_b
    if method == "chol":
        A = m_b[..., :, None] * Dh * m_b[..., None, :] + (
            diag[..., :, None] * jnp.eye(Dh.shape[0])
        )
        chol = jnp.linalg.cholesky(A)
        return jax.scipy.linalg.cho_solve((chol, True), Bmat)
    if method != "cg":
        raise ValueError(f"unknown method: {method!r}")
    mb = m_b[..., None]
    dg = diag[..., None]

    def mv(X):  # (B, S, K)
        return mb * jnp.einsum(
            "st,btk->bsk", Dh, mb * X,
            preferred_element_type=jnp.float32,
        ) + dg * X

    X0 = jnp.zeros_like(Bmat)
    R0 = Bmat
    rs0 = jnp.sum(R0 * R0, axis=-2, keepdims=True)
    # 1e-10 squared-relative exit (1e-5 reduction): fp32 CG stagnates
    # below that and can then DIVERGE — see _sw_masked_cg, where the old
    # 1e-14 exit was measured producing 4e5-magnitude garbage
    # gradients at large active sets
    tol2 = 1e-10 * jnp.maximum(rs0, 1e-30)

    def cond(carry):
        i, _, _, _, rs = carry
        return jnp.logical_and(i < Dh.shape[0] + 8, jnp.any(rs > tol2))

    def body(carry):
        i, X, R, P, rs = carry
        # a column that has met its exit stops moving (alpha = 0 keeps R,
        # hence rs, fixed), so each scenario's result is the one it gets
        # solved alone, whatever else shares its batch
        live = rs > tol2
        Ap = mv(P)
        alpha = jnp.where(
            live, rs / (jnp.sum(P * Ap, axis=-2, keepdims=True) + 1e-30), 0.0
        )
        X = X + alpha * P
        R = R - alpha * Ap
        rs_new = jnp.sum(R * R, axis=-2, keepdims=True)
        P = jnp.where(live, R + (rs_new / (rs + 1e-30)) * P, P)
        return i + 1, X, R, P, rs_new

    _, X, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X0, R0, R0, rs0)
    )
    return X


def active_signs(data: GPADData, y: jax.Array, tol: float = 1e-7):
    """Active-set mask (m_b, plus) from the converged dual.

    Paired y (B, 2, m_h): ``m_b`` is 1.0 where EITHER side's dual exceeds
    ``tol``, and ``plus`` selects which side's rhs map applies. Rows where
    BOTH sides are positive are equality-encoded +/- pairs (their
    difference is the free-signed equality multiplier — e.g. the battery
    charge-coupling rows): for exact-negation pairs the two rhs maps
    coincide, so either selection is correct and the row stays in the
    system as the equality it is. Dense y (B, m): plain 0/1 mask,
    ``plus`` is None. Weakly active rows below ``tol`` are treated as
    inactive (the one-sided derivative from the interior)."""
    if data.paired:
        sp = y[..., 0, :] > tol
        sm = y[..., 1, :] > tol
        m_b = jnp.logical_or(sp, sm).astype(jnp.float32)
        return m_b, sp >= sm
    return (y > tol).astype(jnp.float32), None


def _masked_rhs_map(data: GPADData, m_b: jax.Array, plus):
    """Per-scenario rhs map (B, S, n_p): side-selected, mask-zeroed."""
    r_plus, r_minus = _rhs_maps(data)
    if data.paired:
        sel = jnp.where(plus[..., None], r_plus, r_minus)
        return m_b[..., None] * sel
    return m_b[..., None] * r_plus


def sensitivity(
    data: GPADData,
    y: jax.Array,
    tol: float = 1e-7,
    ridge: float = 0.0,
    method: str = "auto",
):
    """Exact local solution sensitivities at a converged solve.

    ``y`` is the converged dual from ``SolveResult.y`` (the sensitivity
    depends on the parameter only through the dual's active set). Returns
    ``(K_u, K_z)``: ``K_u`` (B, n_u, n_p) = du*/dp — for p = x0 this IS
    the local MPC feedback gain (the piecewise-affine explicit-MPC gain of
    the active region) — and ``K_z`` (B, n_z, n_p) the full-trajectory
    sensitivity."""
    single = y.ndim == (2 if data.paired else 1)
    if single:
        y = y[None]
    m_b, plus = active_signs(data, y, tol)
    # fp32-highest throughout: reduced-precision default matmuls (TF32 on
    # a GPU) would corrupt the KKT solve (same failure mode
    # device_condense documents for its normal equations)
    with jax.default_matmul_precision("highest"):
        R = _masked_rhs_map(data, m_b, plus)  # (B, S, n_p)
        dY = _solve_masked_system(data, m_b, ridge, R, method)
        K_z = (
            -jnp.einsum("sz,bsp->bzp", data.MG_T, dY) - data.gP_map.T[None]
        )
    K_u = K_z[:, : data.n_u]
    if single:
        return K_u[0], K_z[0]
    return K_u, K_z


def feedback_gain(data: GPADData, result, tol: float = 1e-7, ridge=0.0,
                  method: str = "auto"):
    """Local feedback gain du*/dp at a converged ``SolveResult``."""
    return sensitivity(data, result.y, tol=tol, ridge=ridge,
                       method=method)[0]


def make_differentiable_solver(
    data: GPADData,
    config: "_core.SolverConfig | None" = None,
    tol: float = 1e-7,
    ridge: float = 0.0,
    full_trajectory: bool = False,
    method: str = "auto",
):
    """A p -> u*(p) function that is differentiable through the solver.

    Forward = the production engine (``solve_batch`` with ``config`` —
    the fused kernel, restart, eps mode, everything). Backward = the implicit
    KKT adjoint above: one batched masked solve against the SAME symmetric
    system, never unrolling solver iterations. Gradients flow to ``p``
    only; ``data`` is a constant of the closure (cost/model learning wants
    d/dH etc. — re-condense per step and differentiate the condenser with
    plain AD instead, see ``device_condense``).

    ``full_trajectory=False`` returns u* (B, n_u); True returns the whole
    z* (B, n_z). Derivative accuracy matches solve accuracy: converge the
    forward solve (restart=True or a generous budget) before trusting
    gradients."""
    config = config or _core.SolverConfig()

    @jax.custom_vjp
    def solve_u(p):
        res = _core.solve_batch(data, p, config=config)
        z = res.z if full_trajectory else res.u
        return jax.lax.stop_gradient(z)

    def fwd(p):
        res = _core.solve_batch(data, jax.lax.stop_gradient(p), config=config)
        z = res.z if full_trajectory else res.u
        mask = active_signs(data, res.y, tol)
        return jax.lax.stop_gradient(z), jax.lax.stop_gradient(mask)

    def bwd(mask, z_bar):
        m_b, plus = mask
        n_keep = data.n_z if full_trajectory else data.n_u
        z_bar_full = jnp.zeros(z_bar.shape[:-1] + (data.n_z,)).at[
            ..., :n_keep
        ].set(z_bar)
        # fp32-highest: see sensitivity()
        with jax.default_matmul_precision("highest"):
            R = _masked_rhs_map(data, m_b, plus)  # (B, S, n_p)
            t = jnp.einsum("sz,...z->...s", data.MG_T, z_bar_full)
            w = _solve_masked_system(
                data, m_b, ridge, t[..., None], method
            )[..., 0]
            p_bar = -jnp.einsum("...sp,...s->...p", R, w) - jnp.einsum(
                "pz,...z->...p", data.gP_map, z_bar_full
            )
        return (p_bar,)

    solve_u.defvjp(fwd, bwd)
    return solve_u


# ---------------------------------------------------------------------------
# Stage-wise engine: implicit KKT differentiation WITHOUT condensed operands.
#
# Past the condensation wall (the regime the stage-wise engine exists for,
# DESIGN.md section 11) there is no (S, n_z) MG_T/GL_T to build the masked
# system from — but the same dual-space KKT algebra only ever needs two
# linear maps, and the stage-wise LQR oracle IS both of them:
#
#   Hd v   = G H^-1 G' v   -> one LQR solve with (qx, ru) = (Gx'vx, Gu'vu)
#                             from x0 = 0 and zeroed affine constants,
#                             then the stage-local constraint evaluation
#   dg/dx0 -> the closed-loop rollout's x0 dependence (an affine map whose
#             VJP jax.vjp extracts exactly from the same scans)
#
# so the backward pass is matrix-free CG against the SAME oracle the
# forward solve iterates — per CG step one O(N (n+p)^2) sweep instead of a
# condensed O(N^2 n p) MVP. Reference anchor: the parameter maps being
# differentiated, ``acceldualgrad.m:20-23``.
# ---------------------------------------------------------------------------


def _sw_zeroed(data):
    """StagewiseData with its affine constants zeroed: the pure LINEAR
    maps v -> -H^-1 G' v and x0 -> closed-loop rollout, shared by every
    helper below (derivatives never see the affine offsets)."""
    return dataclasses.replace(
        data,
        c_seq=jnp.zeros_like(data.c_seq),
        dtl=jnp.zeros_like(data.dtl),
        qoff=jnp.zeros_like(data.qoff),
    )


def _sw_gz(d0, xs, us):
    """Stage-local constraint evaluation G zeta (no -h), packed (N, m)."""
    gx = jnp.einsum("kn,qn->kq", xs, d0.Gx,
                    precision=jax.lax.Precision.HIGHEST)
    gu = jnp.einsum("kp,qp->kq", us, d0.Gu,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.concatenate([gx, gu], axis=-1)


def _sw_apply_GHiG(d0, v):
    """G H^-1 G' v for one stage-packed dual vector v (N, m_x + m_u)."""
    from tpu_gpad.stagewise import _lqr_solve

    hi = jax.lax.Precision.HIGHEST
    mx = d0.m_x
    qx = jnp.einsum("kq,qn->kn", v[..., :mx], d0.Gx, precision=hi)
    ru = jnp.einsum("kq,qp->kp", v[..., mx:], d0.Gu, precision=hi)
    xs, us = _lqr_solve(d0, qx, ru, jnp.zeros((d0.n_x,), d0.hx.dtype))
    return -_sw_gz(d0, xs, us)  # zeta = -H^-1 G'v, so G zeta = -Hd v


def _sw_masked_cg(d0, m_b, ridge, rhs, cg_iters, cg_rtol2=1e-10):
    """Batched matrix-free CG on (M Hd M + (I - M) + ridge M) w = rhs.

    ``m_b``/``rhs`` are (B, N, m_x + m_u); same SPD structure as the
    condensed ``_solve_masked_system`` CG path, with the matrix applied
    through the stage-wise LQR oracle (one backward+forward sweep per
    iteration) instead of a shared (S, S) matmul. ``cg_rtol2`` is the
    SQUARED relative-residual exit. The default 1e-10 (1e-5 residual
    reduction) is a measured SAFETY bound, not a speed knob: fp32
    CG cannot reach 1e-7 reduction at large active sets — it stagnates
    and then DIVERGES (n8 N240 B64: grad_max 4e5 at the old 1e-14 exit
    vs the correct 5.9 at 1e-10/1e-8, which agree bit-for-bit — and 10x
    the runtime). 1e-5 is already below the fp32 forward plateau."""

    def apply_one(v, mb):
        vm = mb * v
        return mb * _sw_apply_GHiG(d0, vm) + (1.0 - mb) * v + ridge * vm

    mv = jax.vmap(apply_one)
    X0 = jnp.zeros_like(rhs)
    R0 = rhs
    rs0 = jnp.sum(R0 * R0, axis=(-2, -1), keepdims=True)
    tol2 = cg_rtol2 * jnp.maximum(rs0, 1e-30)

    def cond(carry):
        i, _, _, _, rs = carry
        return jnp.logical_and(i < cg_iters, jnp.any(rs > tol2))

    def body(carry):
        i, X, R, P, rs = carry
        Ap = mv(P, m_b)
        alpha = rs / (jnp.sum(P * Ap, axis=(-2, -1), keepdims=True) + 1e-30)
        X = X + alpha * P
        R = R - alpha * Ap
        rs_new = jnp.sum(R * R, axis=(-2, -1), keepdims=True)
        P = R + (rs_new / (rs + 1e-30)) * P
        return i + 1, X, R, P, rs_new

    _, X, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X0, R0, R0, rs0)
    )
    return X


def make_differentiable_stagewise_solver(
    data,
    config=None,
    tol: float = 1e-7,
    ridge: float = 0.0,
    full_trajectory: bool = False,
    cg_iters: "int | None" = None,
):
    """A x0 -> u*(x0) function differentiable through the STAGE-WISE solve.

    The long-horizon twin of ``make_differentiable_solver``: forward =
    ``solve_stagewise`` (kernel/assoc/seq auto routing, restart, eps —
    whatever ``config`` selects), backward = the implicit KKT adjoint in
    stage-packed dual space, with every operator applied matrix-free
    through the LQR oracle (module docstring above). Nothing O(N^2) is
    ever built, so this differentiates at condensation-infeasible shapes
    (e.g. battery n30 N200, where the condensed operands are ~586 MB).

    ``cg_iters`` caps the adjoint CG (default ``N n_u + 40``: the active
    set holds at most n_z rows under LICQ, bounding the Krylov dimension).
    Caveats as the condensed version: gradients assume a CONVERGED solve
    and a strict active set; ``ridge > 0`` regularizes LICQ-degenerate
    actives. ``full_trajectory=True`` returns the whole input trajectory
    z* (B, N n_u) instead of the first move."""
    from tpu_gpad.solver import SolverConfig
    from tpu_gpad.stagewise import _lqr_solve, solve_stagewise

    config = config or SolverConfig()
    d0 = _sw_zeroed(data)
    hi = jax.lax.Precision.HIGHEST
    N, n_u, mx = data.horizon, data.n_u, data.m_x
    n_cg = cg_iters if cg_iters is not None else N * n_u + 40

    @jax.custom_vjp
    def solve_u(x0):
        res = solve_stagewise(data, x0, config=config)
        z = res.z if full_trajectory else res.u
        return jax.lax.stop_gradient(z)

    def fwd(x0):
        res = solve_stagewise(
            data, jax.lax.stop_gradient(x0), config=config)
        z = res.z if full_trajectory else res.u
        m_b = (res.y > tol).astype(res.y.dtype)  # (..., N, m) active mask
        return jax.lax.stop_gradient(z), jax.lax.stop_gradient(m_b)

    def bwd(m_b, z_bar):
        n_keep = N * n_u if full_trajectory else n_u
        lead = z_bar.shape[:-1]
        zb = z_bar.reshape((-1, n_keep))
        m_b = m_b.reshape((-1,) + m_b.shape[-2:])
        B = zb.shape[0]
        ru_bar = jnp.zeros((B, N, n_u), zb.dtype)
        if full_trajectory:
            ru_bar = zb.reshape(B, N, n_u)
        else:
            ru_bar = ru_bar.at[:, 0].set(zb)
        with jax.default_matmul_precision("highest"):
            # t = (dzhat/dw)' zbar = -G H^-1 zbar: one linear LQR solve
            zero_q = jnp.zeros((N, data.n_x), zb.dtype)
            zero_x = jnp.zeros((data.n_x,), zb.dtype)

            def tmap(rb):
                xs, us = _lqr_solve(d0, zero_q, rb, zero_x)
                return _sw_gz(d0, xs, us)  # G(-H^-1 zbar) directly

            t = jax.vmap(tmap)(ru_bar)
            w = m_b * _sw_masked_cg(d0, m_b, ridge, m_b * t, n_cg)
            # cotangent on zeta for the x0-map VJP: the active condition
            # is g_A = (-Hd y + G zeta_x0 + const)_A = 0, so
            # dy = +Msys^-1 M G zeta_x0(dx) and the correction enters
            # POSITIVE: x rows +Gx' w_x, u rows zbar + Gu' w_u
            cot_x = jnp.einsum("bkq,qn->bkn", w[..., :mx], d0.Gx,
                               precision=hi)
            cot_u = ru_bar + jnp.einsum("bkq,qp->bkp", w[..., mx:], d0.Gu,
                                        precision=hi)

            def x0_vjp(cx, cu):
                f = lambda x: _lqr_solve(d0, zero_q,
                                         jnp.zeros((N, n_u), zb.dtype), x)
                _, vjp = jax.vjp(f, zero_x)  # linear map: point-free
                (xb,) = vjp((cx, cu))
                return xb

            x_bar = jax.vmap(x0_vjp)(cot_x, cot_u)
        return (x_bar.reshape(*lead, data.n_x),)

    solve_u.defvjp(fwd, bwd)
    return solve_u


def stagewise_feedback_gain(data, x0, config=None, tol: float = 1e-7,
                            ridge: float = 0.0, cg_iters=None):
    """Local MPC feedback gain du*/dx0 on the stage-wise engine
    (rows of the implicit VJP via ``jax.jacrev``)."""
    f = make_differentiable_stagewise_solver(
        data, config=config, tol=tol, ridge=ridge, cg_iters=cg_iters)
    single = jnp.ndim(x0) == 1
    xb = jnp.atleast_2d(jnp.asarray(x0))
    Kmat = jax.vmap(jax.jacrev(lambda x: f(x[None])[0]))(xb)
    return Kmat[0] if single else Kmat


def make_data_differentiable_solver(
    config: "_core.SolverConfig | None" = None,
    tol: float = 1e-7,
    ridge: float = 0.0,
    full_trajectory: bool = False,
    method: str = "auto",
):
    """A (data, p) -> u*(data, p) function differentiable in BOTH arguments.

    The data-side derivative is the implicit-function theorem applied to
    the solver's own fixed point, written directly in the stored operands.
    With the active conditions q_i + s_i = damp_i*y_i (q = z* @ GL_T,
    s the side-selected p_D offset, z* = -MG_T' y - g_P), the same masked
    symmetric system as the p-only path yields all cotangents as outer
    products of the adjoint solve w with the saved primal/dual point:

        gbar_P   = GL_T @ w_masked - z_bar
        MG_T_bar = outer(y, gbar_P);   GL_T_bar = -outer(z*, w_masked)
        pD_bar   = -/+ w_masked on the active side's rows
        damp_bar = w_masked * y   (soft rows)

    Cotangents for theta/beta/L/D are zero BY DESIGN: the fixed point is
    invariant to the schedule, to L (GL_T/pD_map/soft_damp already carry
    the 1/L scaling — a common rescaling moves all three and cancels
    exactly in these formulas), and D == MG_T @ GL_T duplicates sensitivity
    the MG_T/GL_T paths already account for on any consistently-condensed
    data. This is what makes the layer composable: chain it after a traced
    condenser (``dualize_ltv_device``) and ``jax.grad`` reaches the model
    matrices and cost weights — learning/inverse-MPC through the
    controller. Both-active equality pairs take the PLUS side's offset
    map (``active_signs`` selects it whenever y+ is active; for
    exact-negation pairs the parameter maps coincide, and the constant's
    one-sided derivative is the selected side's).
    """
    config = config or _core.SolverConfig()

    def _zero_like_static(data):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, data)
        return zeros

    @jax.custom_vjp
    def solve_u(data, p):
        res = _core.solve_batch(data, p, config=config)
        z = res.z if full_trajectory else res.u
        return jax.lax.stop_gradient(z)

    def fwd(data, p):
        data_c = jax.lax.stop_gradient(data)
        p_c = jax.lax.stop_gradient(p)
        res = _core.solve_batch(data_c, p_c, config=config)
        mask = active_signs(data_c, res.y, tol)
        y_eff = (
            res.y[..., 0, :] - res.y[..., 1, :] if data_c.paired else res.y
        )
        z = res.z if full_trajectory else res.u
        saved = (data_c, p_c, mask, y_eff, res.z)
        return jax.lax.stop_gradient(z), jax.lax.stop_gradient(saved)

    def bwd(saved, z_bar):
        data, p, (m_b, plus), y_eff, z_star = saved
        n_keep = data.n_z if full_trajectory else data.n_u
        # flatten arbitrary leading batch dims (solve_batch accepts
        # (..., n_p)) to the single 'b' axis the einsums below use
        p_shape = p.shape
        S = m_b.shape[-1]
        p = p.reshape(-1, p_shape[-1])
        z_bar = z_bar.reshape(-1, n_keep)
        m_b = m_b.reshape(-1, S)
        plus = None if plus is None else plus.reshape(-1, S)
        y_eff = y_eff.reshape(-1, S)
        z_star = z_star.reshape(-1, data.n_z)
        z_bar_full = jnp.zeros(z_bar.shape[:-1] + (data.n_z,)).at[
            ..., :n_keep
        ].set(z_bar)
        with jax.default_matmul_precision("highest"):
            t = jnp.einsum("sz,bz->bs", data.MG_T, z_bar_full)
            w = m_b * _solve_masked_system(
                data, m_b, ridge, t[..., None], method
            )[..., 0]  # masked
            r = jnp.einsum("zs,bs->bz", data.GL_T, w)  # (B, n_z)
            gP_bar = r - z_bar_full  # cotangent of g_P(p) per scenario
            MG_bar = jnp.einsum("bs,bz->sz", y_eff, gP_bar)
            GL_bar = -jnp.einsum("bz,bs->zs", z_star, w)
            gPm_bar = jnp.einsum("bp,bz->pz", p, gP_bar)
            gPc_bar = gP_bar.sum(axis=0)
            p_bar = jnp.einsum("pz,bz->bp", data.gP_map, gP_bar)
            if data.paired:
                w_plus = jnp.where(plus, -w, 0.0)  # s = +pD_plus rows
                w_minus = jnp.where(plus, 0.0, w)  # s = -pD_minus rows
                pDm_bar = jnp.stack(
                    [
                        jnp.einsum("bp,bs->ps", p, w_plus),
                        jnp.einsum("bp,bs->ps", p, w_minus),
                    ],
                    axis=1,
                )
                pDc_bar = jnp.stack(
                    [w_plus.sum(axis=0), w_minus.sum(axis=0)], axis=0
                )
                p_bar = p_bar + jnp.einsum(
                    "ps,bs->bp", data.pD_map[:, 0], w_plus
                ) + jnp.einsum("ps,bs->bp", data.pD_map[:, 1], w_minus)
            else:
                pDm_bar = jnp.einsum("bp,bs->ps", p, -w)
                pDc_bar = -w.sum(axis=0)
                p_bar = p_bar + jnp.einsum("ps,bs->bp", data.pD_map, -w)
            damp_bar = (
                (w * y_eff).sum(axis=0)
                if data.soft_damp is not None
                else None
            )
        p_bar = p_bar.reshape(p_shape)
        data_bar = _zero_like_static(data)
        data_bar = dataclasses.replace(
            data_bar,
            MG_T=MG_bar.astype(data.MG_T.dtype),
            GL_T=GL_bar.astype(data.GL_T.dtype),
            gP_map=gPm_bar.astype(data.gP_map.dtype),
            gP_const=gPc_bar.astype(data.gP_const.dtype),
            pD_map=pDm_bar.astype(data.pD_map.dtype),
            pD_const=pDc_bar.astype(data.pD_const.dtype),
            **(
                {"soft_damp": damp_bar.astype(data.soft_damp.dtype)}
                if damp_bar is not None
                else {}
            ),
        )
        return (data_bar, p_bar)

    solve_u.defvjp(fwd, bwd)
    return solve_u

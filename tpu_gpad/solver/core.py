"""Jitted GPAD solver (the L1/L2 online layer).

Design notes
------------
The reference runs one CUDA kernel per algorithm step with device-wide syncs
between them (``main.cu:160-175``). Here the whole iteration is a single
traced loop body: XLA fuses the SAXPY/projection steps around the matmuls,
and batching over scenarios turns them into (B, m) @ (m, n_z) /
(B, n_z) @ (n_z, m) products. There are no host syncs anywhere in the loop.
On a GPU the fixed-iteration dual form runs as one fused kernel instead
(``kernels.dual_loop``; see ``resolve_engine``).

Two termination modes, as in the paper (``nmpc12-gpad.pdf`` Algorithms 1-2):

- ``mode="fixed"``: hard-real-time fixed iteration budget via
  ``lax.fori_loop`` (the only mode the reference enables; ``main.cu:87,160``).
- ``mode="eps"``: epsilon-optimality checks every ``check_every`` iterations
  via ``lax.while_loop``. Under vmap-style batching there is no per-scenario
  early exit in lockstep SIMD; instead a converged mask is carried (the GPAD
  iterate is stationary at the fixed point, so converged lanes keep running
  harmlessly) and the loop exits when *all* scenarios in the (possibly
  mesh-sharded) batch converge — the cross-device reduction is a ``psum``
  over ``collective_axes``. This reproduces the commented epsilon test of
  ``acceldualgrad.m:66-79``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

from tpu_gpad.types import GPADData, SolveResult


@dataclass(frozen=True)
class SolverConfig:
    """Runtime solver configuration (replaces the reference's compile-time
    ``#define`` feature matrix, ``kernel_functions.h:3-7``)."""

    iterations: int | None = None  # fixed budget (or max iters in eps mode);
    # None means "the full length of the shipped theta/beta schedule"
    mode: str = "fixed"  # "fixed" | "eps"
    eps_g: float = 1e-6  # primal feasibility tolerance (acceldualgrad.m:12)
    eps_V: float = 1e-6  # duality-gap tolerance (acceldualgrad.m:13)
    check_every: int = 10  # K, cadence of the eps test (paper sec. 5.1 uses K=10)
    engine: str = "auto"  # "auto" | "xla" | "pallas". "auto" picks the fused
    # dual-loop kernel (kernels.dual_loop) on a CUDA GPU when it applies
    # (kernels.admits: paired data with D, fixed mode, no model-axis TP,
    # a dual height within its measured limits) and the XLA loop engine
    # otherwise. Forcing "pallas" raises where the kernel cannot run. The
    # stage-wise engine ignores this field — problem-LEVEL routing between
    # condensed and stage-wise lives in stagewise.auto_solver / the CLI.
    form: str = "auto"  # "auto" | "mvp" | "dual": iteration algebra. "mvp"
    # runs the four explicit steps (two rectangular MVPs per iteration, the
    # reference's structure); "dual" runs the collapsed dual-only iteration
    # (one square (m_h, m_h) matmul per iteration against the precomputed
    # dual Hessian D, primal recovered after the loop) — needs paired data
    # with D, fixed mode, and no model-axis TP. "auto" picks "dual" when
    # available.
    matmul_dtype: str = "float32"  # operand dtype for the hot matmuls;
    # "bfloat16" runs them on the tensor cores with fp32 accumulation (XLA
    # loop only: the fused kernel takes fp32 operands)
    precision: str = "highest"  # lax matmul precision for fp32 operands.
    # On an H100 (measured, PERF.md): "highest" is true fp32 — cuBLAS FFMA
    # kernels on the XLA path, IEEE fp32 FMA in the fused kernel, no TF32.
    # "default" lets the XLA loop use TF32 tensor cores (~1e-3 relative per
    # product); "high" is not a tier of its own there: XLA picks per
    # product (the solver's u* error at "high" is TF32-sized, a lone
    # product measured fp32-exact). The fused kernel runs every tier in
    # full fp32: TF32 allows, not requires, and its TF32 blocks ran 6x
    # slower than its fp32 ones.
    collective_axes: tuple = ()  # mesh axes to psum the all-converged test over
    model_axis: str | None = None  # mesh axis the dual dimension m is sharded
    # over (tensor parallelism): step-2 partial products are psum'd per
    # iteration; residual reductions become pmax/psum over this axis
    unroll: int = 1  # fori_loop unroll factor
    flat: str = "auto"  # "auto" | "on" | "off": exploit the input-box
    # identity block of the half stack (GPADData.n_struct — the batched
    # analogue of the reference's flat kernels, seq_functions.cpp:5-43,
    # kernel_functions.cu:74-109). In the mvp form, step 4's box columns
    # are I/L, so q splits into one (n_z, n_struct) matmul plus zhat/L —
    # a 2*n_z^2 flop cut per iteration (~25% at the 30x30 reference shape).
    # "auto" uses it whenever detected (mvp form, no model-axis TP);
    # "on" raises if unavailable; "off" forces the dense product. The dual
    # form is unaffected (its square Hessian has no exploitable block).
    diagnostics: bool = True  # fixed-mode only: False skips the residual/
    # duality-gap recovery entirely — the fused kernel drops its w outputs
    # and the post-loop recovery matmuls are skipped;
    # SolveResult.residual/gap come back as NaN. u/z/y are bit-identical,
    # so warm-started serving loops lose nothing. Requires mode="fixed"
    # (the eps test needs the residuals).
    restart: bool = False  # O'Donoghue-Candes adaptive restart: reset the
    # momentum recursion (theta -> 1, extrapolation cleared) per scenario
    # whenever the momentum direction opposes the projected-gradient step,
    # (w - y+) . (y+ - y) > 0. Turns the O(1/k^2) tail into effectively
    # linear convergence on the bundled MPC duals (machine precision in
    # ~100 iterations vs ~1e-3 for the plain schedule; eps=1e-6 in ~60
    # iterations vs ~230). No reference analogue; theta/beta are computed
    # on the fly per scenario and the certified bounds of tpu_gpad.bounds
    # do not apply.


def affine_params(data: GPADData, x0: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-scenario dual constants: g_P(x0), p_D(x0) (acceldualgrad.m:21,23).

    In the paired layout ``p_D`` has shape (..., 2, m_h). Full fp32: a
    default-precision product may run in TF32 on a GPU, and its ~1e-3
    relative error would set the accuracy floor of every solve."""
    hi = lax.Precision.HIGHEST
    g_P = jnp.tensordot(x0, data.gP_map, axes=1, precision=hi) + data.gP_const
    p_D = jnp.tensordot(x0, data.pD_map, axes=1, precision=hi) + data.pD_const
    return g_P, p_D


def _make_matmul(config: "SolverConfig"):
    """Hot-loop matmul closure: operand dtype + precision from config."""
    mm_dtype = jnp.dtype(config.matmul_dtype)
    precision = lax.Precision(config.precision.lower())

    def mm(a, b):
        return jnp.matmul(
            a.astype(mm_dtype),
            b.astype(mm_dtype),
            precision=precision,
            preferred_element_type=jnp.float32,
        )

    return mm


def resolve_flat(data: GPADData, config: "SolverConfig") -> bool:
    """Whether the mvp iteration exploits the input-box identity block."""
    avail = (
        data.paired
        and data.n_struct is not None
        and config.model_axis is None  # GL_T columns shard under TP
    )
    if config.flat == "auto":
        return avail
    if config.flat == "on":
        if not avail:
            raise ValueError(
                "flat='on' needs paired data with a detected identity block "
                "(GPADData.n_struct) and no model-axis sharding"
            )
        return True
    if config.flat == "off":
        return False
    raise ValueError(f"unknown flat: {config.flat!r}")


def _step4_product(data: GPADData, zhat, mm, flat: bool):
    """q = zhat @ GL_T for the paired layout, exploiting the identity block
    when ``flat``: the box columns of GL_T are exactly I/L, so they cost a
    scalar multiply instead of matmul columns (the reference's flat-kernel
    trick, ``kernel_functions.cu:74-109``; ~2*n_z^2 flops saved/iter)."""
    if not flat:
        return mm(zhat, data.GL_T)
    ns = data.n_struct
    if ns == 0:  # box-only stack: the whole product is the identity block
        return zhat / data.L
    q_s = mm(zhat, data.GL_T[:, :ns])
    q_b = zhat / data.L
    return jnp.concatenate([q_s, q_b], axis=-1)


def _iteration(data: GPADData, g_P, p_D, theta_k, beta_k, y, y_prev, z, mm,
               model_axis=None, flat: bool = False):
    """One GPAD iteration (steps 1-4, acceldualgrad.m:43-52), batched.

    Under tensor parallelism (``model_axis`` set, dual dimension m sharded
    across the mesh inside shard_map) step 2's row-slice partial products are
    reduced with a single psum; steps 1/3/4 are embarrassingly local.
    """
    w = y + _expand_to(jnp.asarray(beta_k), y) * (y - y_prev)
    if data.paired:
        # half-stack layout: contract the +/- difference once (step 2) and
        # apply the single product with both signs (step 4) — half the flops
        w_diff = w[..., 0, :] - w[..., 1, :]
        zhat_partial = mm(w_diff, data.MG_T)
    else:
        zhat_partial = mm(w, data.MG_T)
    if model_axis is not None:
        zhat_partial = lax.psum(zhat_partial, model_axis)
    zhat = -zhat_partial - g_P
    theta_z = _expand_to(jnp.asarray(theta_k), z)
    z = (1.0 - theta_z) * z + theta_z * zhat
    # soft (quadratic-penalty) rows damp their dual: the -(1/2 rho)||y||^2
    # dual regularization's gradient term -(w/rho)/L folds into a per-row
    # scaling of w (GPADData.soft_damp); 1-2 VPU ops, no extra matmul
    w_s = w if data.soft_damp is None else w * (1.0 - data.soft_damp)
    if data.paired:
        q = _step4_product(data, zhat, mm, flat)
        y_next = jnp.maximum(w_s + jnp.stack([q, -q], axis=-2) + p_D, 0.0)
    else:
        y_next = jnp.maximum(w_s + mm(zhat, data.GL_T) + p_D, 0.0)
    return w, zhat, z, y_next


def _residuals(data: GPADData, g_P, p_D, z, zhat, w, mm, model_axis=None,
               flat: bool = False, y=None):
    """Primal violation max(G z - b) and gap surrogate -w' g(zhat).

    Recovered from the scaled operands: g(z) = L * (G_L z + p_D). For
    SOFT rows (``data.soft_damp``) the violation is measured against the
    recovered slack (s* = y/rho for z, w/rho for zhat) and the gap uses
    the REGULARIZED dual gradient g(zhat) - w/rho — both reduce to the
    hard expressions when soft_damp is None. ``y`` (the current dual
    iterate) is only consulted for soft rows."""
    if data.paired:
        qz = _step4_product(data, z, mm, flat)
        qzh = _step4_product(data, zhat, mm, flat)
        gz = data.L * (jnp.stack([qz, -qz], axis=-2) + p_D)
        gzh = data.L * (jnp.stack([qzh, -qzh], axis=-2) + p_D)
    else:
        gz = data.L * (mm(z, data.GL_T) + p_D)
        gzh = data.L * (mm(zhat, data.GL_T) + p_D)
    if data.soft_damp is not None:
        # L * damp == 1/rho on soft rows, 0 elsewhere
        if y is not None:
            gz = gz - (data.L * data.soft_damp) * y
        gzh = gzh - (data.L * data.soft_damp) * w
    if data.paired:
        viol_z = jnp.max(gz, axis=(-2, -1))
        viol_zhat = jnp.max(gzh, axis=(-2, -1))
        gap = -jnp.sum(w * gzh, axis=(-2, -1))
    else:
        viol_z = jnp.max(gz, axis=-1)
        viol_zhat = jnp.max(gzh, axis=-1)
        gap = -jnp.sum(w * gzh, axis=-1)
    if model_axis is not None:
        viol_z = lax.pmax(viol_z, model_axis)
        viol_zhat = lax.pmax(viol_zhat, model_axis)
        gap = lax.psum(gap, model_axis)
    return viol_z, viol_zhat, gap


def _expand_to(v, like):
    """Append trailing singleton dims so ``v`` broadcasts against ``like``."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def _momentum(config: "SolverConfig", data: GPADData, k, th, th_prev):
    """Raw (theta_k, beta_k): precomputed schedule scalars normally; the
    per-scenario on-the-fly recursion (carried th, th_prev) in restart
    mode. Consumers expand with ``_expand_to`` against their operand."""
    if not config.restart:
        return data.theta[k], data.beta[k]
    return th, th * (1.0 / th_prev - 1.0)


def _restart_update(config: "SolverConfig", th, th_prev, y, y_next, w):
    """Advance the momentum recursion, resetting scenarios whose momentum
    direction opposes the projected-gradient step (O'Donoghue-Candes):
    restart iff (w - y+) . (y+ - y) > 0. Returns (y_prev', th', th_prev')."""
    tail = tuple(range(th.ndim, y.ndim))
    r = jnp.sum((w - y_next) * (y_next - y), axis=tail)
    if config.model_axis is not None:
        r = lax.psum(r, config.model_axis)
    mask = r > 0.0
    th_next = jnp.where(
        mask, 1.0, th * (jnp.sqrt(th * th + 4.0) - th) * 0.5
    )
    th_prev_next = jnp.where(mask, 1.0, th)
    y_prev_next = jnp.where(_expand_to(mask, y), y_next, y)
    return y_prev_next, th_next, th_prev_next


def _init_state(data: GPADData, batch_shape, y0=None):
    """Initial iterates; ``y0`` warm-starts the dual (both y and y_prev, so
    the first extrapolation step is momentum-free from the warm point)."""
    zeros = functools.partial(jnp.zeros, dtype=jnp.float32)
    dual_shape = (2, data.m_half) if data.paired else (data.m,)
    if y0 is None:
        y = zeros(batch_shape + dual_shape)
    else:
        y = jnp.broadcast_to(
            jnp.asarray(y0, dtype=jnp.float32), batch_shape + dual_shape
        )
    y_prev = y
    z = zeros(batch_shape + (data.n_z,))
    w = zeros(batch_shape + dual_shape)
    zhat = zeros(batch_shape + (data.n_z,))
    return y, y_prev, z, w, zhat


def _dual_loop(data: GPADData, e, p_D, config: SolverConfig, y0=None):
    """The fixed-budget dual iteration as an XLA ``fori_loop``.

    Per iteration: one (B, m_h) @ (m_h, m_h) matmul + SAXPYs. ``e`` is
    g_P GL_T, hoisted out of the loop. Returns the final dual ``y``, the
    momentum combination ``s`` of the w-difference iterates (the primal
    is recovered from it, see ``_solve_fixed_dual``) and the last
    extrapolated dual ``w``."""
    mm = _make_matmul(config)
    batch_shape = e.shape[:-1]
    m_h = data.m_half
    zeros = functools.partial(jnp.zeros, dtype=jnp.float32)
    if y0 is None:
        y = zeros(batch_shape + (2, m_h))
    else:
        y = jnp.broadcast_to(
            jnp.asarray(y0, dtype=jnp.float32), batch_shape + (2, m_h)
        )
    y_prev = y
    w = zeros(batch_shape + (2, m_h))
    s = zeros(batch_shape + (m_h,))
    ones = jnp.ones(batch_shape, dtype=jnp.float32)

    def body(k, carry):
        y, y_prev, s, _, th, th_prev = carry
        theta_k, beta_k = _momentum(config, data, k, th, th_prev)
        w = y + _expand_to(jnp.asarray(beta_k), y) * (y - y_prev)
        wd = w[..., 0, :] - w[..., 1, :]
        q = -mm(wd, data.D) - e
        w_s = w if data.soft_damp is None else w * (1.0 - data.soft_damp)
        y_next = jnp.maximum(w_s + jnp.stack([q, -q], axis=-2) + p_D, 0.0)
        theta_s = _expand_to(jnp.asarray(theta_k), s)
        s = (1.0 - theta_s) * s + theta_s * wd
        if config.restart:
            y_prev_n, th, th_prev = _restart_update(
                config, th, th_prev, y, y_next, w
            )
        else:
            y_prev_n = y
        return y_next, y_prev_n, s, w, th, th_prev

    y, _, s, w, _, _ = lax.fori_loop(
        0, config.iterations, body, (y, y_prev, s, w, ones, ones),
        unroll=config.unroll,
    )
    return y, s, w


def _solve_fixed_dual(data: GPADData, g_P, p_D, config: SolverConfig, y0=None,
                      loop=_dual_loop) -> SolveResult:
    """Dual-only fixed-budget solve (see GPADData.D).

    ``loop`` runs the iteration: the XLA ``_dual_loop`` or the fused GPU
    kernel ``kernels.dual_loop``. The primal z is reconstructed once after
    the loop from the accumulated momentum combination s:

        zhat_k = -(wd_k @ MG_T) - g_P,  z_K = sum_k c_k zhat_k
        => z_K = -(s_K @ MG_T) - a_K g_P,   s following the same convex
           recursion as z, and a_K = 1 - prod_k (1 - theta_k).
    """
    mm = _make_matmul(config)
    batch_shape = g_P.shape[:-1]
    e = mm(g_P, data.GL_T)  # (B, m_h), hoisted out of the loop
    y, s, w = loop(data, e, p_D, config, y0)
    a = 1.0 - jnp.prod(1.0 - data.theta[: config.iterations])
    z = -mm(s, data.MG_T) - a * g_P
    if config.diagnostics:
        wd = w[..., 0, :] - w[..., 1, :]
        zhat = -mm(wd, data.MG_T) - g_P
        viol_z, _, gap = _residuals(data, g_P, p_D, z, zhat, w, mm, y=y)
        residual = jnp.maximum(viol_z, 0.0)
    else:
        residual = jnp.full(batch_shape, jnp.nan, dtype=jnp.float32)
        gap = residual
    iters = jnp.full(batch_shape, config.iterations, dtype=jnp.int32)
    return SolveResult(
        u=z[..., : data.n_u],
        z=z,
        y=y,
        iterations=iters,
        residual=residual,
        gap=gap,
        converged=jnp.ones(batch_shape, dtype=bool),
    )


def resolve_engine(data: GPADData, config: SolverConfig, y0=None) -> str:
    """Pick the execution engine for this (data, config, warm-start) combo.

    "auto" (the default) takes the fused dual kernel exactly when it
    applies (``kernels.admits``: paired data with D, fixed mode, no
    model-axis TP, a dual height within its measured limits) and the
    backend is a CUDA GPU; the XLA loop otherwise. The rule does not
    read ``config.diagnostics`` or ``y0``, so flipping either never
    switches engines. Forcing "pallas" raises where the kernel cannot
    run (it has no CPU lowering)."""
    from tpu_gpad.solver import kernels

    if config.engine == "xla":
        return "xla"
    if config.engine not in ("auto", "pallas"):
        raise ValueError(f"unknown engine: {config.engine!r}")
    ok, why = kernels.admits(data, config)
    if config.engine == "pallas":
        if not ok:
            raise ValueError(f"engine='pallas': the fused dual kernel {why}")
        if not kernels.on_gpu():
            raise ValueError(
                "engine='pallas' compiles for a CUDA GPU only; use "
                "engine='auto' or 'xla' on this backend"
            )
        return "pallas"
    return "pallas" if ok and kernels.on_gpu() else "xla"


def resolve_form(data: GPADData, config: SolverConfig) -> str:
    """Pick the iteration algebra for this (data, config) combination."""
    dual_ok = (
        data.paired
        and data.D is not None
        and config.mode == "fixed"
        and config.model_axis is None
    )
    if config.form == "auto":
        return "dual" if dual_ok else "mvp"
    if config.form == "dual":
        if not dual_ok:
            raise ValueError(
                "form='dual' needs paired data with D, fixed mode, and no "
                "model-axis sharding"
            )
        return "dual"
    if config.form == "mvp":
        return "mvp"
    raise ValueError(f"unknown form: {config.form!r}")


def _solve_fixed(data: GPADData, g_P, p_D, config: SolverConfig, y0=None) -> SolveResult:
    mm = _make_matmul(config)
    flat = resolve_flat(data, config)
    batch_shape = g_P.shape[:-1]
    y, y_prev, z, w, zhat = _init_state(data, batch_shape, y0)
    ones = jnp.ones(batch_shape, dtype=jnp.float32)

    def body(k, carry):
        y, y_prev, z, _, _, th, th_prev = carry
        theta_k, beta_k = _momentum(config, data, k, th, th_prev)
        w, zhat, z, y_next = _iteration(
            data, g_P, p_D, theta_k, beta_k, y, y_prev, z, mm,
            config.model_axis, flat,
        )
        if config.restart:
            y_prev_n, th, th_prev = _restart_update(
                config, th, th_prev, y, y_next, w
            )
        else:
            y_prev_n = y
        return y_next, y_prev_n, z, w, zhat, th, th_prev

    y, y_prev, z, w, zhat, _, _ = lax.fori_loop(
        0, config.iterations, body, (y, y_prev, z, w, zhat, ones, ones),
        unroll=config.unroll,
    )
    if config.diagnostics:
        viol_z, _, gap = _residuals(
            data, g_P, p_D, z, zhat, w, mm, config.model_axis, flat, y=y
        )
        residual = jnp.maximum(viol_z, 0.0)
    else:
        residual = jnp.full(batch_shape, jnp.nan, dtype=jnp.float32)
        gap = residual
    iters = jnp.full(batch_shape, config.iterations, dtype=jnp.int32)
    return SolveResult(
        u=z[..., : data.n_u],
        z=z,
        y=y,
        iterations=iters,
        residual=residual,
        gap=gap,
        converged=jnp.ones(batch_shape, dtype=bool),
    )


def _solve_eps(data: GPADData, g_P, p_D, config: SolverConfig, y0=None) -> SolveResult:
    mm = _make_matmul(config)
    flat = resolve_flat(data, config)
    batch_shape = g_P.shape[:-1]
    y, y_prev, z, w, zhat = _init_state(data, batch_shape, y0)
    converged = jnp.zeros(batch_shape, dtype=bool)
    iters = jnp.full(batch_shape, config.iterations, dtype=jnp.int32)
    z_out = z  # primal point captured at first convergence per scenario
    k0 = jnp.asarray(0, dtype=jnp.int32)
    done = jnp.asarray(False)

    def cond(carry):
        k, done, *_ = carry
        return jnp.logical_and(k < config.iterations, jnp.logical_not(done))

    def body(carry):
        k, done, y, y_prev, z, w, zhat, converged, iters, z_out, th, th_prev = carry
        theta_k, beta_k = _momentum(config, data, k, th, th_prev)
        w, zhat, z, y_next = _iteration(
            data, g_P, p_D, theta_k, beta_k, y, y_prev, z, mm,
            config.model_axis, flat,
        )
        if config.restart:
            y_prev, th, th_prev = _restart_update(
                config, th, th_prev, y, y_next, w
            )
        else:
            y_prev = y
        y = y_next

        def check(args):
            converged, iters, z_out = args
            viol_z, viol_zhat, gap = _residuals(
                data, g_P, p_D, z, zhat, w, mm, config.model_axis, flat, y=y
            )
            ok_z = viol_z <= config.eps_g
            ok_zhat = jnp.logical_and(viol_zhat <= config.eps_g, gap <= config.eps_V)
            ok = jnp.logical_or(ok_z, ok_zhat)
            newly = jnp.logical_and(ok, jnp.logical_not(converged))
            iters = jnp.where(newly, k + 1, iters)
            # On the zhat branch the eps-optimal point is zhat (paper Alg. 1):
            # it is exactly optimal for the Lagrangian at w, while the averaged
            # z may still be infeasible.
            z_sel = jnp.where(ok_z[..., None], z, zhat)
            z_out = jnp.where(newly[..., None], z_sel, z_out)
            return jnp.logical_or(converged, ok), iters, z_out

        # check every K iterations, plus once at the budget end when the
        # budget is not a multiple of K (same semantics as the chunked
        # pallas path's final partial window)
        do_check = jnp.logical_or(
            (k + 1) % config.check_every == 0, k + 1 == config.iterations
        )
        converged, iters, z_out = lax.cond(
            do_check, check, lambda a: a, (converged, iters, z_out)
        )
        n_unconverged = jnp.sum(jnp.logical_not(converged).astype(jnp.int32))
        for ax in config.collective_axes:
            n_unconverged = lax.psum(n_unconverged, ax)
        done = n_unconverged == 0
        return k + 1, done, y, y_prev, z, w, zhat, converged, iters, z_out, th, th_prev

    ones = jnp.ones(batch_shape, dtype=jnp.float32)
    carry = (k0, done, y, y_prev, z, w, zhat, converged, iters, z_out, ones, ones)
    (k, done, y, y_prev, z, w, zhat, converged, iters, z_out, _, _) = lax.while_loop(
        cond, body, carry
    )
    z_final = jnp.where(converged[..., None], z_out, z)
    viol_z, _, gap = _residuals(
        data, g_P, p_D, z_final, zhat, w, mm, config.model_axis, flat, y=y
    )
    return SolveResult(
        u=z_final[..., : data.n_u],
        z=z_final,
        y=y,
        iterations=iters,
        residual=jnp.maximum(viol_z, 0.0),
        gap=gap,
        converged=converged,
    )


@functools.partial(jax.jit, static_argnames=("config",))
def solve_batch(
    data: GPADData,
    x0: jax.Array,
    config: SolverConfig = SolverConfig(),
    y0: jax.Array | None = None,
) -> SolveResult:
    """Solve a batch of MPC QPs: ``x0`` has shape (..., n_x).

    All scenarios share the plant (hence ``MG_T``/``GL_T``); per-scenario
    constants are the affine maps of x0. The returned ``SolveResult`` fields
    carry the same leading batch dims.

    ``y0`` warm-starts the dual iterate (e.g. the previous closed-loop
    sample's ``result.y``) — the reference always cold-starts from zero
    (``acceldualgrad.m:28-33``); warm starting cuts the iterations needed
    per closed-loop sample severalfold. Shape must broadcast to the dual
    state shape ((..., m) dense / (..., 2, m_half) paired). Note the
    certified bounds of ``tpu_gpad.bounds`` assume the cold start.
    """
    import dataclasses as _dc

    n_iters = config.iterations if config.iterations is not None else data.max_iters
    if n_iters > data.max_iters and not config.restart:
        # restart mode computes theta/beta on the fly and ignores the
        # shipped schedule, so any budget is fine there
        raise ValueError(
            f"config asks for {n_iters} iterations but the shipped momentum "
            f"schedule only has {data.max_iters}; re-dualize with a longer one"
        )
    config = _dc.replace(config, iterations=n_iters)
    if not config.diagnostics and config.mode != "fixed":
        raise ValueError(
            "diagnostics=False requires mode='fixed' (the eps termination "
            "test needs the residual/gap diagnostics)"
        )
    g_P, p_D = affine_params(data, x0)
    if resolve_engine(data, config, y0) == "pallas":
        from tpu_gpad.solver import kernels

        return _solve_fixed_dual(data, g_P, p_D, config, y0, kernels.dual_loop)
    if config.mode == "fixed":
        if resolve_form(data, config) == "dual":
            return _solve_fixed_dual(data, g_P, p_D, config, y0)
        return _solve_fixed(data, g_P, p_D, config, y0)
    if config.mode == "eps":
        resolve_form(data, config)  # validate form compatibility
        return _solve_eps(data, g_P, p_D, config, y0)
    raise ValueError(f"unknown mode: {config.mode!r}")


def solve(
    data: GPADData,
    x0: jax.Array,
    config: SolverConfig = SolverConfig(),
    y0: jax.Array | None = None,
) -> SolveResult:
    """Single-scenario solve: ``x0`` of shape (n_x,)."""
    if y0 is not None and y0.ndim in (1, 2):
        y0 = y0[None]
    return solve_batch(data, x0[None, :], config=config, y0=y0)


def solve_to_accuracy(
    data: GPADData,
    x0: jax.Array,
    tol: float = 1e-5,
    max_iterations: int = 2000,
    check_every: int = 10,
    y0: jax.Array | None = None,
    **config_kw,
) -> SolveResult:
    """Solve until eps-optimality ``tol`` (primal infeasibility and duality
    gap), with adaptive restart on — the fastest route to an accuracy
    target (eps=1e-5 in <=80 iterations on the bundled problems vs ~250
    for the plain schedule). Convenience wrapper over ``solve_batch`` with
    ``mode='eps'``; check ``result.converged`` for scenarios that hit
    ``max_iterations`` first. ``x0`` may be (n_x,) or (B, n_x)."""
    # honor the caller's cap: a check cadence longer than the budget shrinks
    # to one window rather than inflating the budget (non-divisible budgets
    # run a final partial check window on every engine)
    check_every = max(min(check_every, max_iterations), 1)
    config = SolverConfig(
        mode="eps",
        eps_g=tol,
        eps_V=tol,
        check_every=check_every,
        iterations=max_iterations,
        restart=True,
        **config_kw,
    )
    if x0.ndim == 1:
        return solve(data, x0, config=config, y0=y0)
    return solve_batch(data, x0, config=config, y0=y0)

"""Fused GPAD dual loop for the GPU (Pallas, Triton route).

The XLA engine runs the dual-form iteration (``core._dual_loop``) as a
``fori_loop`` whose body is one (B, m_h) @ (m_h, m_h) product plus a few
elementwise fusions, so every iteration is several kernel launches and a
round trip of the (B, 2, m_h) dual state through device memory. Here the
whole fixed-iteration loop is ONE launch: each program owns a block of
``BLOCK_B`` scenarios and

- keeps y+, y-, their previous values and the primal-recovery sum s in
  registers for all iterations;
- holds the (chunk, chunk) blocks of ``-D`` (m_h zero-padded) in
  registers for all iterations;
- reads theta/beta from a small global array (the momentum schedule the
  reference ships with the problem, ``main.cu:61-64``);
- writes each output once.

Blocks share nothing, so they run in parallel on all SMs. Zero padding is
inert: padded rows/columns of ``-D``, of e and of the offsets are zero, so
padded dual lanes stay identically zero, and padded scenarios solve the
all-zero problem.

The kernel only compiles for a CUDA GPU. Tests on the CPU call
``dual_loop`` with ``interpret=True``; ``solve_batch`` never does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from tpu_gpad.types import GPADData

# Admission, measured on an H100 (PERF.md): the largest dual half-height
# m_half the kernel takes. Solves run in 16-column chunks and win up to
# nine chunks (3.3x the XLA loop at m_half=140; at 210, in 32-column
# chunks, 12x slower: the blocks of -D no longer fit in registers). Larger
# duals are real GEMMs that the XLA loop hands to cuBLAS.
MAX_DUAL_ROWS = 144
# Launch shape, chosen on an H100 at the headline shape (PERF.md):
# scenarios per program and warps per program.
BLOCK_B = 16
NUM_WARPS = 4
# Every product runs as (CHUNK, CHUNK) blocks in full fp32 on the FMA units,
# which need a contraction this short to keep both operands in registers;
# the blocks of -D are loaded once before the loop. Every fp32 precision
# tier runs this way: "high" and "default" allow TF32 but do not require
# it, and TF32 (or bf16) tensor-core blocks ran 6x slower than these
# (PERF.md). bfloat16 operands take the XLA loop.
CHUNK = 16
_MIN_ROWS = 16  # Triton's dot needs every operand dimension >= 16


def on_gpu() -> bool:
    """The backend seam: the kernel compiles only for a CUDA GPU."""
    return jax.default_backend() == "gpu"


def padded_rows(m_half: int) -> int:
    """Dual half-height padded to the power of two Triton blocks need."""
    return max(_MIN_ROWS, 1 << (int(m_half) - 1).bit_length())


def admits(data: GPADData, config) -> tuple[bool, str]:
    """(ok, reason): can the fused dual kernel run this (data, config)?"""
    if not (data.paired and data.D is not None):
        return False, "needs paired data with the dual Hessian D"
    if config.mode != "fixed":
        return False, "covers mode='fixed' only"
    if config.model_axis is not None:
        return False, "does not shard the dual dimension (model_axis)"
    if config.form == "mvp":
        return False, "runs the dual form only"
    if config.iterations is not None and config.iterations < 1:
        return False, "needs at least one iteration"
    if jnp.dtype(config.matmul_dtype) != jnp.float32:
        return False, "runs fp32 operands only (bf16 operands take the XLA loop)"
    if data.m_half > MAX_DUAL_ROWS:
        return False, f"m_half={data.m_half} > MAX_DUAL_ROWS={MAX_DUAL_ROWS}"
    return True, ""


def _dual_kernel(
    theta_ref, beta_ref, e_ref, pp_ref, pm_ref, dn_ref, *refs,
    iterations: int, n_chunks: int, chunk: int,
    restart: bool, warm: bool, soft: bool, diagnostics: bool,
):
    """One block of scenarios through the whole fixed-budget dual loop.

    Same algebra, in the same order of fp32 additions, as
    ``core._dual_loop``, with the negation of D folded into ``dn``:

        w+- = y+- + beta (y+- - y_prev+-)
        q   = (w+ - w-) @ (-D) - e,      e = g_P GL_T
        y+  = relu(w+ (1 - damp) + q + p+),  y- = relu(w- (1 - damp) - q + p-)
        s  += theta ((w+ - w-) - s)

    e stays apart from the offsets p+-: folded into them once, its fp32
    rounding is a fixed error that the fixed point amplifies (measured:
    3x the XLA loop's distance from a float64 loop, PERF.md).

    Every state row is held as ``n_chunks`` column chunks of width
    ``chunk``, and the product runs as n_chunks^2 (chunk, chunk) block
    products; columns past the last chunk holding dual rows are never
    touched. With several chunks the blocks of -D are loaded once, before
    the loop. The last iteration is peeled so the final w (a diagnostics
    output) never has to be a loop carry."""
    refs = list(refs)
    y0p_ref, y0m_ref = (refs.pop(0), refs.pop(0)) if warm else (None, None)
    od_ref = refs.pop(0) if soft else None
    s_ref, yp_ref, ym_ref, *w_refs = refs
    f32 = jnp.float32
    cols = [pl.ds(j * chunk, chunk) for j in range(n_chunks)]
    load = lambda ref: tuple(ref[:, c] for c in cols)
    e, pp, pm = load(e_ref), load(pp_ref), load(pm_ref)
    od = None if od_ref is None else load(od_ref)  # (1, chunk): 1 - soft_damp
    zero = tuple(jnp.zeros_like(c) for c in e)
    yp0 = load(y0p_ref) if warm else zero
    ym0 = load(y0m_ref) if warm else zero
    one = jnp.ones((e[0].shape[0], 1), f32)
    dn_blk = lambda c, j: dn_ref[cols[c], cols[j]]
    if n_chunks > 1:
        dn_h = [[dn_blk(c, j) for j in range(n_chunks)] for c in range(n_chunks)]
        dn_blk = lambda c, j: dn_h[c][j]

    def step(k, carry):
        yp, ym, ypp, ymp, s, th, thp = carry
        if restart:
            theta_k, beta_k = th, th * (1.0 / thp - 1.0)
        else:
            theta_k, beta_k = theta_ref[k], beta_ref[k]
        wp = tuple(y + beta_k * (y - yq) for y, yq in zip(yp, ypp))
        wm = tuple(y + beta_k * (y - yq) for y, yq in zip(ym, ymp))
        wd = tuple(a - b for a, b in zip(wp, wm))
        q = [
            functools.reduce(jnp.add, [
                jnp.dot(wd[c], dn_blk(c, j), precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=f32)
                for c in range(n_chunks)
            ]) - e[j]
            for j in range(n_chunks)
        ]
        wp_s = wp if od is None else tuple(a * o for a, o in zip(wp, od))
        wm_s = wm if od is None else tuple(a * o for a, o in zip(wm, od))
        yp_n = tuple(jnp.maximum(a + qj + c, 0.0) for a, qj, c in zip(wp_s, q, pp))
        ym_n = tuple(jnp.maximum(a - qj + c, 0.0) for a, qj, c in zip(wm_s, q, pm))
        s = tuple(si + theta_k * (x - si) for si, x in zip(s, wd))
        if restart:
            # O'Donoghue-Candes: restart iff (w - y+) . (y+ - y) > 0 over
            # both halves; padded lanes contribute zeros
            r = functools.reduce(jnp.add, [
                jnp.sum((a - b) * (b - c), axis=1, keepdims=True)
                for a, b, c in zip(wp + wm, yp_n + ym_n, yp + ym)
            ])
            mask = r > 0.0
            th_n = jnp.where(mask, 1.0, th * (jnp.sqrt(th * th + 4.0) - th) * 0.5)
            thp = jnp.where(mask, 1.0, th)
            ypp = tuple(jnp.where(mask, a, b) for a, b in zip(yp_n, yp))
            ymp = tuple(jnp.where(mask, a, b) for a, b in zip(ym_n, ym))
            th = th_n
        else:
            ypp, ymp = yp, ym
        return (yp_n, ym_n, ypp, ymp, s, th, thp), wp, wm

    carry = (yp0, ym0, yp0, ym0, zero, one, one)
    carry = jax.lax.fori_loop(
        0, iterations - 1, lambda k, c: step(k, c)[0], carry
    )
    (yp, ym, _, _, s, _, _), wp, wm = step(iterations - 1, carry)
    outs = [(s_ref, s), (yp_ref, yp), (ym_ref, ym)]
    if diagnostics:
        outs += [(w_refs[0], wp), (w_refs[1], wm)]
    for ref, val in outs:
        for c, v in zip(cols, val):
            ref[:, c] = v


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "restart", "diagnostics", "interpret"),
)
def _dual_call(
    D, theta, beta, e, p_D, y0, od, *, iterations, restart, diagnostics,
    interpret,
):
    B, m_h = e.shape
    S = padded_rows(m_h)
    chunk = min(CHUNK, S)
    n_chunks = -(-m_h // chunk)
    B_p = -(-B // BLOCK_B) * BLOCK_B
    pad = lambda x: jnp.pad(x, ((0, B_p - B), (0, S - m_h)))
    K_p = padded_rows(iterations)
    # restart mode may run past the shipped schedule (it ignores it)
    sched = lambda v: jnp.pad(v[:iterations], (0, K_p - min(v.shape[0], iterations)))
    operands = [
        sched(theta), sched(beta),
        pad(e), pad(p_D[:, 0, :]), pad(p_D[:, 1, :]),
        jnp.pad(-D, ((0, S - m_h), (0, S - m_h))),
    ]
    row = pl.BlockSpec((BLOCK_B, S), lambda i: (i, 0))
    in_specs = [
        pl.BlockSpec((K_p,), lambda i: (0,)),
        pl.BlockSpec((K_p,), lambda i: (0,)),
        row, row, row,
        pl.BlockSpec((S, S), lambda i: (0, 0)),
    ]
    if y0 is not None:
        operands += [pad(y0[:, 0, :]), pad(y0[:, 1, :])]
        in_specs += [row, row]
    if od is not None:
        operands.append(jnp.pad(od[None, :], ((0, 0), (0, S - m_h)),
                                constant_values=1.0))
        in_specs.append(pl.BlockSpec((1, S), lambda i: (0, 0)))
    n_out = 5 if diagnostics else 3
    kernel = functools.partial(
        _dual_kernel, iterations=iterations, n_chunks=n_chunks, chunk=chunk,
        restart=restart, warm=y0 is not None, soft=od is not None, diagnostics=diagnostics,
    )
    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((B_p, S), jnp.float32)] * n_out,
        grid=(B_p // BLOCK_B,),
        in_specs=in_specs,
        out_specs=[row] * n_out,
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="gpad_dual_loop",
    )(*operands)
    # columns past the last chunk are never written: crop before use
    crop = lambda x: x[:B, :m_h]
    s, yp, ym = map(crop, outs[:3])
    y = jnp.stack([yp, ym], axis=1)
    w = jnp.stack([crop(outs[3]), crop(outs[4])], axis=1) if diagnostics else None
    return y, s, w


def dual_loop(data: GPADData, e, p_D, config, y0=None, *, interpret=False):
    """The fused replacement for ``core._dual_loop``: same arguments, same
    ``(y, s, w)`` result (``w`` is None without diagnostics).

    ``e`` is g_P GL_T (batch..., m_h), ``p_D`` (batch..., 2, m_h), ``y0``
    an optional warm-start dual broadcastable to (batch..., 2, m_h).
    ``interpret=True`` runs the Pallas interpreter (CPU tests only)."""
    ok, why = admits(data, config)
    if not ok:
        raise ValueError(f"the fused dual kernel cannot run this problem: {why}")
    batch_shape = e.shape[:-1]
    m_h = data.m_half
    e2 = e.reshape((-1, m_h))
    B = e2.shape[0]
    if y0 is not None:
        y0 = jnp.broadcast_to(
            jnp.asarray(y0, jnp.float32), batch_shape + (2, m_h)
        ).reshape((B, 2, m_h))
    od = None if data.soft_damp is None else 1.0 - data.soft_damp.astype(jnp.float32)
    y, s, w = _dual_call(
        data.D, data.theta, data.beta, e2, p_D.reshape((B, 2, m_h)), y0, od,
        iterations=config.iterations, restart=config.restart,
        diagnostics=config.diagnostics, interpret=interpret,
    )
    unflat = lambda x: None if x is None else x.reshape(batch_shape + x.shape[1:])
    return unflat(y), unflat(s), unflat(w)

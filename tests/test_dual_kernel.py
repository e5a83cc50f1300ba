"""The fused dual-loop kernel (``solver/kernels.py``, Pallas Triton route).

On the CPU the kernel runs in Pallas interpret mode (the same kernel body
the GPU compiles) against the XLA dual loop ``core._dual_loop``; its
CUDA lowering (Pallas -> Triton IR) is checked without a card; the
admission rule and ``engine="auto"`` routing are plain Python. Tests
marked ``gpu`` compile the kernel for the card and skip elsewhere:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (or
``python chip_smoke.py``, whose phase (g) runs them).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.device_condense import dualize_ltv_device
from tpu_gpad.solver import SolverConfig, core, kernels, solve_batch
from tpu_gpad.solver.reference import gpad_solve_qp

interp_loop = functools.partial(kernels.dual_loop, interpret=True)


@functools.lru_cache(maxsize=None)
def _battery(n=3, N=10, iterations=100):
    qp = tpu_gpad.condense(problems.battery(n_cells=n, horizon=N))
    return qp, tpu_gpad.dualize(qp, iterations=iterations, paired="auto")


@functools.lru_cache(maxsize=None)
def _soft():
    rng = np.random.default_rng(11)
    A = np.stack([np.eye(3) + 0.08 * rng.standard_normal((3, 3))
                  for _ in range(6)])
    B = 0.4 * rng.standard_normal((6, 3, 2))
    c = 0.02 * rng.standard_normal((6, 3))
    return dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(c),
        np.eye(3), 0.5 * np.eye(2), np.full(2, -1.0), np.full(2, 1.0),
        iterations=300, x_min=np.full(3, -0.2), x_max=np.full(3, 0.2),
        soft_state=10.0,
    )


def _x(n_x, B, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-scale, scale, (B, n_x)).astype(np.float32))


def _pair(data, X, cfg, y0=None, loop=interp_loop):
    """(kernel, XLA) results of the dual-form solve of the same batch."""
    g_P, p_D = core.affine_params(data, X)
    got = core._solve_fixed_dual(data, g_P, p_D, cfg, y0, loop)
    ref = core._solve_fixed_dual(data, g_P, p_D, cfg, y0)
    return got, ref


def _close(got, ref, atol=2e-5, diagnostics=True, signed_dual=False):
    """``signed_dual`` compares y+ - y- only: on equality-encoded row pairs
    (both sides active) the split between the halves is not unique."""
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u), atol=atol)
    np.testing.assert_allclose(np.asarray(got.z), np.asarray(ref.z), atol=atol)
    y_of = lambda r: np.asarray(r.y[..., 0, :] - r.y[..., 1, :]) if signed_dual \
        else np.asarray(r.y)
    np.testing.assert_allclose(y_of(got), y_of(ref), atol=atol)
    if diagnostics:
        np.testing.assert_allclose(
            np.asarray(got.residual), np.asarray(ref.residual), atol=atol)
        np.testing.assert_allclose(
            np.asarray(got.gap), np.asarray(ref.gap), atol=atol)
    else:
        assert np.isnan(np.asarray(got.residual)).all()


@pytest.mark.parametrize("diagnostics", [True, False], ids=["diag", "nodiag"])
@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_kernel_matches_xla_loop(warm, restart, diagnostics):
    _, data = _battery()
    X = _x(data.n_x, 20)
    cfg = SolverConfig(iterations=60, restart=restart, diagnostics=diagnostics)
    y0 = None
    if warm:
        g_P, p_D = core.affine_params(data, X * 0.9)
        y0 = core._solve_fixed_dual(
            data, g_P, p_D, dataclasses.replace(cfg, iterations=30)).y
    got, ref = _pair(data, X, cfg, y0)
    # a restart test at r ~ 0 may flip with the summation order, after
    # which the two momentum recursions differ slightly
    _close(got, ref, atol=1e-4 if restart else 2e-5, diagnostics=diagnostics,
           signed_dual=restart)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_kernel_soft_rows_match_xla(warm):
    dev = _soft()
    rng = np.random.default_rng(5)
    X = jnp.asarray(np.concatenate(
        [rng.uniform(-0.5, 0.5, (6, 3)), np.zeros((6, 3))], axis=1
    ).astype(np.float32))
    cfg = SolverConfig(iterations=200)
    y0 = None
    if warm:
        y0 = solve_batch(dev, X, config=SolverConfig(iterations=100)).y
    got, ref = _pair(dev, X, cfg, y0)
    _close(got, ref)
    # non-vacuous: the damped (soft) rows carry active duals
    soft = np.asarray(dev.soft_damp) > 0
    assert np.asarray(got.y)[:, :, soft].max() > 1e-3


@pytest.mark.parametrize(
    "kw",
    [dict(precision="high"), dict(precision="default"),
     dict(matmul_dtype="bfloat16")],
    ids=["high", "default", "bf16"],
)
def test_kernel_precision_tiers(kw):
    """Every fp32 tier runs the kernel's full-fp32 blocks, bit for bit the
    "highest" result; bf16 operands are refused (the XLA loop takes
    them)."""
    _, data = _battery()
    X = _x(data.n_x, 16, seed=2)
    cfg = SolverConfig(iterations=60, **kw)
    if "matmul_dtype" in kw:
        ok, why = kernels.admits(data, cfg)
        assert not ok and "fp32" in why
        with pytest.raises(ValueError, match="fp32"):
            _pair(data, X, cfg)
        return
    got, _ = _pair(data, X, cfg)
    hi, _ = _pair(data, X, SolverConfig(iterations=60))
    np.testing.assert_array_equal(np.asarray(got.u), np.asarray(hi.u))
    np.testing.assert_array_equal(np.asarray(got.y), np.asarray(hi.y))


@pytest.mark.parametrize(
    "make",
    [
        lambda: problems.double_integrator(horizon=5),
        lambda: problems.mass_spring(horizon=6),
        lambda: problems.battery(n_cells=3, horizon=4),
        lambda: problems.battery(n_cells=2, horizon=2),
        lambda: problems.battery(n_cells=3, horizon=20),
    ],
    ids=["double_integrator", "mass_spring", "battery_n3N4", "battery_n2N2",
         "battery_n3N20"],
)
def test_kernel_dual_padding(make):
    """Dual heights far from a power of two (and below 16, and past one
    chunk group: m_half=140 is nine 16-column chunks) pad inertly."""
    qp = tpu_gpad.condense(make())
    data = tpu_gpad.dualize(qp, iterations=100, paired="auto")
    assert kernels.admits(data, SolverConfig(iterations=50))[0]
    X = _x(data.n_x, 5, seed=3, scale=0.4)
    got, ref = _pair(data, X, SolverConfig(iterations=50))
    _close(got, ref)


@pytest.mark.parametrize("B", [1, 15, 16, 17, 33])
def test_kernel_batch_padding(B):
    _, data = _battery()
    got, ref = _pair(data, _x(data.n_x, B, seed=B), SolverConfig(iterations=40))
    _close(got, ref)


def test_kernel_leading_batch_dims_and_broadcast_y0():
    _, data = _battery()
    X = _x(data.n_x, 6, seed=4).reshape(2, 3, data.n_x)
    cfg = SolverConfig(iterations=40)
    y0 = core._solve_fixed_dual(
        data, *core.affine_params(data, X[0, 0]), cfg).y  # (2, m_h)
    got, ref = _pair(data, X, cfg, y0)
    assert got.u.shape == (2, 3, data.n_u) and got.y.shape == (2, 3, 2, data.m_half)
    _close(got, ref)


def test_kernel_matches_oracle():
    qp, data = _battery()
    X = _x(data.n_x, 8, seed=7)
    got, _ = _pair(data, X, SolverConfig(iterations=100))
    for i in range(8):
        ref = gpad_solve_qp(qp, np.asarray(X[i], np.float64), iterations=100)
        np.testing.assert_allclose(np.asarray(got.u[i]), ref.u, atol=1e-4)


def test_kernel_restart_runs_past_schedule():
    """Restart ignores the shipped schedule, so the budget may exceed it."""
    _, data = _battery(iterations=50)
    got, ref = _pair(data, _x(data.n_x, 4, seed=8),
                     SolverConfig(iterations=80, restart=True))
    _close(got, ref)


def test_kernel_single_iteration():
    """The peeled last iteration alone (zero loop trips)."""
    _, data = _battery()
    got, ref = _pair(data, _x(data.n_x, 4, seed=9), SolverConfig(iterations=1))
    _close(got, ref, atol=1e-6)


@pytest.mark.parametrize(
    "case, ok, reason",
    [
        ("fits", True, ""),
        ("unpaired", False, "paired"),
        ("eps", False, "mode='fixed'"),
        ("model_axis", False, "model_axis"),
        ("mvp", False, "dual form"),
        ("zero_iterations", False, "at least one"),
        ("fp32_too_tall", False, "MAX_DUAL_ROWS"),
        ("tc_too_tall", False, "MAX_DUAL_ROWS"),
        ("tc_fits", True, ""),
        ("bf16", False, "fp32"),
    ],
)
def test_admission_rule(case, ok, reason):
    _, data = _battery()
    cfg = SolverConfig(iterations=100)
    if case == "unpaired":
        data = tpu_gpad.dualize(_battery()[0], iterations=100, paired=False)
    elif case == "eps":
        cfg = dataclasses.replace(cfg, mode="eps")
    elif case == "model_axis":
        cfg = dataclasses.replace(cfg, model_axis="model")
    elif case == "mvp":
        cfg = dataclasses.replace(cfg, form="mvp")
    elif case == "zero_iterations":
        cfg = dataclasses.replace(cfg, iterations=0)
    elif case == "fp32_too_tall":
        data = _battery(N=30)[1]  # m_half=210 > 144
    elif case == "tc_too_tall":  # every tier shares the one limit
        data = _battery(N=30)[1]
        cfg = dataclasses.replace(cfg, precision="default")
    elif case == "tc_fits":
        data = _battery(N=20)[1]  # m_half=140: nine chunks
        cfg = dataclasses.replace(cfg, precision="default")
    elif case == "bf16":
        cfg = dataclasses.replace(cfg, matmul_dtype="bfloat16")
    got, why = kernels.admits(data, cfg)
    assert got == ok and reason in why


@pytest.mark.parametrize(
    "gpu, kw, expect",
    [
        (True, {}, "pallas"),
        (True, dict(mode="eps"), "xla"),
        (True, dict(engine="xla"), "xla"),
        (False, {}, "xla"),
        (False, dict(engine="pallas"), ValueError),
        (True, dict(engine="pallas", form="mvp"), ValueError),
        (True, dict(engine="cuda"), ValueError),
    ],
    ids=["gpu-auto", "gpu-eps", "gpu-xla", "cpu-auto", "cpu-forced",
         "gpu-forced-mvp", "unknown"],
)
def test_auto_routing(monkeypatch, gpu, kw, expect):
    _, data = _battery()
    monkeypatch.setattr(kernels, "on_gpu", lambda: gpu)
    cfg = SolverConfig(iterations=100, **kw)
    if expect is ValueError:
        with pytest.raises(ValueError):
            core.resolve_engine(data, cfg)
    else:
        assert core.resolve_engine(data, cfg) == expect


@pytest.mark.parametrize("m_half, rows", [(1, 16), (16, 16), (17, 32),
                                          (70, 128), (140, 256)])
def test_padded_rows(m_half, rows):
    assert kernels.padded_rows(m_half) == rows


@pytest.mark.parametrize(
    "case",
    ["cold", "warm_restart", "soft", "nodiag", "bf16", "tf32", "nine_chunks",
     "tf32_nine_chunks"],
)
def test_kernel_lowers_for_cuda(monkeypatch, case):
    """``solve_batch`` on a GPU lowers to the Triton kernel for CUDA,
    checked without a card (the GPU compile of that IR is what the ``gpu``
    tests add); bf16 operands lower to the XLA loop instead."""
    monkeypatch.setattr(kernels, "on_gpu", lambda: True)
    data = _soft() if case == "soft" else _battery(N=20 if "nine" in case else 10)[1]
    kw = {"warm_restart": dict(restart=True), "nodiag": dict(diagnostics=False),
          "bf16": dict(matmul_dtype="bfloat16"),
          "tf32": dict(precision="default"),
          "tf32_nine_chunks": dict(precision="default")}.get(case, {})
    cfg = SolverConfig(iterations=100, **kw)
    X = _x(data.n_x, 64)
    y0 = jnp.zeros((64, 2, data.m_half)) if case == "warm_restart" else None

    def f(X, y0):
        return solve_batch(data, X, config=cfg, y0=y0).u

    text = jax.jit(f).trace(X, y0).lower(lowering_platforms=("cuda",)).as_text()
    assert ("triton" in text) == (case != "bf16")


# --- compiled on the card (skipped elsewhere) ------------------------------

gpu = pytest.mark.usefixtures("gpu")


@pytest.mark.gpu
@gpu
@pytest.mark.parametrize(
    "kw, N",
    [({}, 10), (dict(restart=True), 10), (dict(diagnostics=False), 10),
     (dict(precision="default"), 10), ({}, 20), (dict(precision="default"), 20)],
    ids=["highest", "restart", "nodiag", "tf32", "nine_chunks",
         "tf32_nine_chunks"],
)
def test_compiled_kernel_matches_xla(kw, N):
    """The XLA loop at "default" runs TF32 products (~1e-3); the kernel
    runs every fp32 tier in full fp32."""
    _, data = _battery(N=N)
    X = _x(data.n_x, 1000, seed=11)
    cfg = SolverConfig(iterations=100, **kw)
    atol = 1e-2 if "precision" in kw else 2e-5
    got, ref = _pair(data, X, cfg, loop=kernels.dual_loop)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u), atol=atol)


def dual_loop_f64(data, X, cfg, y0=None):
    """``core._dual_loop`` (plain schedule) in float64 NumPy, from the
    same fp32 inputs (p_D and e = g_P GL_T) the two fp32 loops start from:
    the yardstick for how far fp32 rounding carries the dual over 100
    iterations."""
    g_P, p_D = core.affine_params(data, X)
    e = np.asarray(core._make_matmul(cfg)(g_P, data.GL_T), np.float64)
    p_D = np.asarray(p_D, np.float64)
    D = np.asarray(data.D, np.float64)
    keep = 1.0 if data.soft_damp is None else 1.0 - np.asarray(data.soft_damp, np.float64)
    y = np.zeros(p_D.shape) if y0 is None else np.asarray(y0, np.float64)
    y_prev = y
    for k in range(cfg.iterations):
        w = y + float(data.beta[k]) * (y - y_prev)
        q = -(w[:, 0] - w[:, 1]) @ D - e
        y_prev, y = y, np.maximum(w * keep + np.stack([q, -q], axis=1) + p_D, 0.0)
    return y


def _case(case, B):
    """(data, X, y0) of the named dual-loop case, B scenarios."""
    y0 = None
    if case == "soft":
        data = _soft()
        rng = np.random.default_rng(5)
        X = jnp.asarray(np.concatenate(
            [rng.uniform(-0.5, 0.5, (B, 3)), np.zeros((B, 3))], axis=1
        ).astype(np.float32))
    else:
        data = _battery(N=20 if case == "nine_chunks" else 10)[1]
        X = _x(data.n_x, B, seed=12)
    if case == "warm":
        y0 = solve_batch(data, X * 0.9, config=SolverConfig(iterations=50,
                                                            engine="xla")).y
    return data, X, y0


@pytest.mark.parametrize("case", ["warm", "soft", "nine_chunks"])
def test_f64_dual_loop_matches_xla(case):
    """The float64 yardstick of the card tests is the same loop: on the
    CPU the XLA fp32 loop stays within fp32 rounding of it."""
    data, X, y0 = _case(case, 16)
    cfg = SolverConfig(iterations=100)
    y = core._solve_fixed_dual(data, *core.affine_params(data, X), cfg, y0).y
    np.testing.assert_allclose(np.asarray(y), dual_loop_f64(data, X, cfg, y0),
                               atol=2e-5)


@pytest.mark.gpu
@gpu
@pytest.mark.parametrize("case", ["warm", "soft", "nine_chunks"])
def test_compiled_kernel_cases(case):
    cfg = SolverConfig(iterations=100)
    data, X, y0 = _case(case, 64 if case == "soft" else 1000)
    got, ref = _pair(data, X, cfg, y0, loop=kernels.dual_loop)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u), atol=2e-5)
    # the duals: fp32 rounding over 100 iterations carries both loops away
    # from the float64 one; the kernel may not stray farther than twice
    # the XLA loop's own distance
    y64 = dual_loop_f64(data, X, cfg, y0)
    err_k = np.abs(np.asarray(got.y) - y64).max()
    err_x = np.abs(np.asarray(ref.y) - y64).max()
    assert err_k <= max(2.0 * err_x, 2e-5), (err_k, err_x)


@pytest.mark.gpu
@gpu
def test_auto_takes_kernel_on_gpu():
    _, data = _battery()
    assert core.resolve_engine(data, SolverConfig(iterations=100)) == "pallas"

"""Native C++ step library vs the NumPy oracle (the reference's
seq_functions.cpp role, SURVEY.md C5) and the CLI binary (main.cu role, C3)."""

import subprocess

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import native, problems
from tpu_gpad.condense import condense, dualize, lipschitz_constant
from tpu_gpad.schedule import momentum_schedule
from tpu_gpad.solver import reference as oracle

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


@pytest.fixture(scope="module")
def dual_constants():
    qp = condense(problems.battery(n_cells=3, horizon=6))
    L = lipschitz_constant(qp)
    x0 = problems.battery_default_x0(3, seed=2)
    f = qp.F.T @ x0
    b = qp.b0 + qp.E @ x0
    M_G = np.linalg.solve(qp.H, qp.G.T)  # (n_z, m)
    g_P = np.linalg.solve(qp.H, f)
    return qp, M_G, g_P, qp.G / L, -b / L, L


def test_steps_match_numpy(dual_constants, rng):
    qp, M_G, g_P, G_L, p_D, L = dual_constants
    m, n_z = qp.m, qp.n_z
    y = rng.random(m).astype(np.float32)
    y_prev = rng.random(m).astype(np.float32)
    w = native.step1(y, y_prev, 0.3)
    np.testing.assert_allclose(w, oracle.step1(y, y_prev, 0.3), rtol=1e-6)
    zhat = native.step2(M_G.T, w, g_P)  # MG_T = (m, n_z)
    np.testing.assert_allclose(
        zhat, oracle.step2(M_G.astype(np.float32), w, g_P.astype(np.float32)),
        atol=1e-5,
    )
    z = native.step3(rng.random(n_z).astype(np.float32), zhat, 0.04)
    y4 = native.step4(G_L.T, w, p_D, zhat)
    np.testing.assert_allclose(
        y4,
        oracle.step4(G_L.astype(np.float32), w, p_D.astype(np.float32), zhat),
        atol=1e-5,
    )
    assert (y4 >= 0).all()
    assert z.shape == (n_z,)


def test_full_solve_matches_oracle(dual_constants):
    qp, M_G, g_P, G_L, p_D, L = dual_constants
    theta, beta = momentum_schedule(100)
    z, y = native.solve_fixed(M_G.T, G_L.T, g_P, p_D, theta, beta, 100)
    ref = oracle.gpad_solve(M_G, g_P, G_L, p_D, qp.n_u, iterations=100)
    np.testing.assert_allclose(z, ref.z, atol=2e-5)
    np.testing.assert_allclose(y, ref.y, atol=2e-5)


def test_paired_solve_matches_dense(dual_constants):
    qp, M_G, g_P, G_L, p_D, L = dual_constants
    data = dualize(qp, iterations=100, paired=True)
    theta, beta = momentum_schedule(100)
    # paired constants from the jax data (already permuted/stacked)
    x0 = problems.battery_default_x0(3, seed=2).astype(np.float32)
    pD2 = np.tensordot(x0, np.asarray(data.pD_map), 1) + np.asarray(data.pD_const)
    z_p, y_p = native.solve_fixed_paired(
        np.asarray(data.MG_T), np.asarray(data.GL_T),
        g_P, pD2, theta, beta, 100,
    )
    ref = oracle.gpad_solve(M_G, g_P, G_L, p_D, qp.n_u, iterations=100)
    np.testing.assert_allclose(z_p, ref.z, atol=3e-5)


def test_paired_flat_solve_matches_paired(dual_constants):
    """The structure-exploiting flat solve (the reference's flat-variant
    role, seq_functions.cpp:5-43) is exact algebra on the paired solve."""
    qp, M_G, g_P, G_L, p_D, L = dual_constants
    data = dualize(qp, iterations=100, paired=True)
    assert data.n_struct is not None and data.n_struct > 0
    theta, beta = momentum_schedule(100)
    x0 = problems.battery_default_x0(3, seed=2).astype(np.float32)
    pD2 = np.tensordot(x0, np.asarray(data.pD_map), 1) + np.asarray(data.pD_const)
    z_f, y_f = native.solve_fixed_paired_flat(
        np.asarray(data.MG_T),
        np.asarray(data.GL_T)[:, : data.n_struct],
        g_P, pD2, theta, beta, float(np.asarray(data.L)), 100,
    )
    z_p, y_p = native.solve_fixed_paired(
        np.asarray(data.MG_T), np.asarray(data.GL_T),
        g_P, pD2, theta, beta, 100,
    )
    np.testing.assert_allclose(z_f, z_p, atol=2e-6)
    np.testing.assert_allclose(y_f, y_p, atol=2e-6)


def test_batch_solve(dual_constants, rng):
    qp, M_G, g_P, G_L, p_D, L = dual_constants
    theta, beta = momentum_schedule(50)
    B = 3
    gPb = np.stack([g_P, g_P * 0.5, g_P * -0.2]).astype(np.float32)
    pDb = np.stack([p_D, p_D * 1.1, p_D * 0.9]).astype(np.float32)
    Z, Y = native.solve_fixed_batch(M_G.T, G_L.T, gPb, pDb, theta, beta, 50)
    for b in range(B):
        z1, y1 = native.solve_fixed(M_G.T, G_L.T, gPb[b], pDb[b], theta, beta, 50)
        np.testing.assert_array_equal(Z[b], z1)


def test_cli_binary(tmp_path, dual_constants):
    """End-to-end: write a reference-format dataset, run the native binary,
    check the printed u* against the oracle (main.cu behavior)."""
    from tpu_gpad.io import SolverDataset, write_solver_dataset

    qp, M_G, g_P, G_L, p_D, L = dual_constants
    theta, beta = momentum_schedule(100)
    ds = SolverDataset(
        n_u=3, N=6, m=qp.m, num_iterations=100, L=L,
        M_G=M_G.astype(np.float32), g_P=g_P.astype(np.float32),
        G_L=G_L.astype(np.float32), p_D=p_D.astype(np.float32),
        theta=theta, beta=beta,
    )
    path = tmp_path / "input_1.txt"
    write_solver_dataset(path, ds)  # writes pre-negated M_G (CUDA convention)
    cli = native.build_cli()
    out = subprocess.run(
        [str(cli), str(path)], capture_output=True, text=True, check=True
    ).stdout
    u_line = next(l for l in out.splitlines() if l.startswith("u* ="))
    u = np.array([float(t) for t in u_line.split()[2:]])
    ref = oracle.gpad_solve(M_G, g_P, G_L, p_D, qp.n_u, iterations=100)
    np.testing.assert_allclose(u, ref.u, atol=5e-4)
    assert "avg per-iteration" in out


def test_native_stagewise_solve_matches_xla():
    """The native C++ stage-wise fixed-budget solve (the CPU baseline of
    the O(N) engine — the reference's seq library is condensed-only)
    reproduces solve_stagewise's iterates, diagnostics included, on LTI
    and LTV plants with affine offsets."""
    import dataclasses

    from tpu_gpad import problems
    from tpu_gpad.stagewise import build_stagewise, solve_stagewise

    rng = np.random.default_rng(0)
    ltv = problems.random_ltv(n_x=3, n_u=2, horizon=6, seed=3)
    battery_c = dataclasses.replace(
        problems.battery(3, 6),
        c=rng.uniform(-0.02, 0.02, size=(6, 3)),
    )
    for prob, iters in ((problems.battery(3, 6), 60), (ltv, 80),
                        (battery_c, 60)):
        data = build_stagewise(prob, iterations=iters)
        x0 = rng.uniform(-0.3, 0.3, size=prob.n_x).astype(np.float32)
        ref = solve_stagewise(data, x0[None], iterations=iters)
        u0, zu, y, resid, gap = native.solve_stagewise_fixed(
            data, x0, iters)
        np.testing.assert_allclose(u0, np.asarray(ref.u[0]), atol=1e-6)
        np.testing.assert_allclose(
            zu.reshape(-1), np.asarray(ref.z[0]), atol=1e-6)
        np.testing.assert_allclose(y, np.asarray(ref.y[0]), atol=2e-6)
        assert abs(resid - float(ref.residual[0])) < 1e-6
        assert abs(gap - float(ref.gap[0])) < 1e-5

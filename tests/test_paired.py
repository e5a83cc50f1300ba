"""Paired (half-stack) layout: exploiting the [P; -P] structure of box
constraint stacks halves the hot-MVP flops. Must be numerically equivalent
to the dense layout (the dual y merely permutes)."""

import numpy as np
import pytest

import tpu_gpad

from tpu_gpad import problems
from tpu_gpad.condense import condense, dualize, find_pairing
from tpu_gpad.solver import SolverConfig, solve_batch


@pytest.fixture(scope="module")
def battery_qp():
    return condense(problems.battery(n_cells=3, horizon=10))


def _x0(n, n_x, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.4, 0.4, size=(n, n_x)).astype(np.float32)


def test_find_pairing_battery(battery_qp):
    qp = battery_qp
    pairing = find_pairing(qp.G)
    assert pairing is not None
    plus, minus = pairing
    assert len(plus) == qp.m // 2
    np.testing.assert_array_equal(qp.G[minus], -qp.G[plus])


def test_find_pairing_rejects_unpaired():
    G = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    assert find_pairing(G) is None
    G2 = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [1.0, 1.0]])
    assert find_pairing(G2) is None


def test_dualize_paired_shapes(battery_qp):
    data = dualize(battery_qp, iterations=50, paired=True)
    assert data.paired
    assert data.m == battery_qp.m
    assert data.m_half == battery_qp.m // 2
    assert data.MG_T.shape == (data.m_half, data.n_z)
    assert data.GL_T.shape == (data.n_z, data.m_half)
    assert data.pD_const.shape == (2, data.m_half)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_paired_matches_dense(battery_qp, engine, interpret_kernel):
    """The paired layout (through ``engine``: "pallas" is the fused dual
    kernel, interpreted here) against the dense layout's XLA loop."""
    qp = battery_qp
    X0 = _x0(12, qp.n_x)
    dd = dualize(qp, iterations=100)
    dp = dualize(qp, iterations=100, paired=True)
    rd = solve_batch(dd, X0, config=SolverConfig(iterations=100, engine="xla"))
    rp = solve_batch(dp, X0, config=SolverConfig(iterations=100, engine=engine))
    np.testing.assert_allclose(np.asarray(rp.z), np.asarray(rd.z), atol=3e-5)
    np.testing.assert_allclose(np.asarray(rp.u), np.asarray(rd.u), atol=3e-5)
    np.testing.assert_allclose(
        np.asarray(rp.residual), np.asarray(rd.residual), atol=3e-5
    )
    assert rp.y.shape == (12, 2, dp.m_half)


def test_paired_eps_mode(battery_qp):
    dp = dualize(battery_qp, iterations=500, paired=True)
    dd = dualize(battery_qp, iterations=500)
    X0 = _x0(6, battery_qp.n_x, seed=7)
    cfg = SolverConfig(mode="eps", eps_g=1e-3, eps_V=1e-3, check_every=5)
    rp = solve_batch(dp, X0, config=cfg)
    rd = solve_batch(dd, X0, config=cfg)
    assert bool(np.all(np.asarray(rp.converged)))
    np.testing.assert_array_equal(np.asarray(rp.iterations), np.asarray(rd.iterations))
    np.testing.assert_allclose(np.asarray(rp.u), np.asarray(rd.u), atol=3e-5)


def test_paired_auto_fallback():
    """paired='auto' on a one-sided problem silently uses the dense layout."""
    prob = problems.double_integrator(horizon=5)
    import dataclasses

    one_sided = dataclasses.replace(prob, x_min=None, name="one_sided")
    qp = condense(one_sided)
    data = dualize(qp, iterations=10, paired="auto")
    assert not data.paired
    with pytest.raises(ValueError, match="pairing"):
        dualize(qp, iterations=10, paired=True)


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 8,
    reason="needs the 8-device (virtual CPU) mesh",
)
def test_paired_sharded(battery_qp):
    """DP + dual-dimension TP over the half stack (m_h=70 not divisible by 2
    -> use horizon 8 with m_h=136=8*17... just test DP + model=1 and a
    divisible TP case)."""
    import jax
    from tpu_gpad.parallel import make_mesh, solve_batch_sharded, shard_batch

    qp = condense(problems.battery(n_cells=3, horizon=4))  # m=56, m_h=28
    data = dualize(qp, iterations=60, paired=True)
    mesh = make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8])
    X0 = _x0(8, qp.n_x, seed=3)
    out = solve_batch_sharded(
        data, shard_batch(mesh, X0), SolverConfig(iterations=60),
        mesh=mesh, model_axis="model",
    )
    dd = dualize(qp, iterations=60)
    ref = solve_batch(dd, X0, config=SolverConfig(iterations=60))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u), atol=3e-5)


def test_dual_form_matches_mvp(battery_qp):
    """The collapsed dual-only iteration is algebraically identical to the
    four explicit steps; iterates agree to fp32 roundoff."""
    from tpu_gpad.solver.core import resolve_form

    qp = battery_qp
    X0 = _x0(8, qp.n_x, seed=21)
    dp = dualize(qp, iterations=100, paired=True)
    cfg_mvp = SolverConfig(iterations=100, form="mvp")
    cfg_dual = SolverConfig(iterations=100, form="dual")
    # form auto takes the dual form wherever it is available
    assert resolve_form(dp, SolverConfig(iterations=100)) == "dual"
    rm = solve_batch(dp, X0, config=cfg_mvp)
    rd = solve_batch(dp, X0, config=cfg_dual)
    np.testing.assert_allclose(
        np.asarray(rd.u), np.asarray(rm.u), atol=3e-5)
    np.testing.assert_allclose(
        np.asarray(rd.z), np.asarray(rm.z), atol=3e-5)
    np.testing.assert_allclose(
        np.asarray(rd.y), np.asarray(rm.y), atol=3e-4)
    np.testing.assert_allclose(
        np.asarray(rd.residual), np.asarray(rm.residual),
        atol=3e-5,
    )


def test_dual_form_requires_paired(battery_qp):
    dd = dualize(battery_qp, iterations=50)  # dense
    X0 = _x0(2, battery_qp.n_x)
    with pytest.raises(ValueError, match="dual"):
        solve_batch(dd, X0, config=SolverConfig(iterations=50, form="dual"))
    # auto on dense silently uses mvp
    r = solve_batch(dd, X0, config=SolverConfig(iterations=50, form="auto"))
    assert r.u.shape == (2, battery_qp.n_u)


def test_dual_form_pallas_matches_xla(battery_qp, interpret_kernel):
    dp = dualize(battery_qp, iterations=100, paired=True)
    X0 = _x0(10, battery_qp.n_x, seed=31)
    cfg_x = SolverConfig(iterations=100, form="dual", engine="xla")
    cfg_p = SolverConfig(iterations=100, form="dual", engine="pallas")
    rx = solve_batch(dp, X0, config=cfg_x)
    rp = solve_batch(dp, X0, config=cfg_p)
    np.testing.assert_allclose(np.asarray(rp.u), np.asarray(rx.u), atol=2e-5)
    np.testing.assert_allclose(np.asarray(rp.y), np.asarray(rx.y), atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(rp.residual), np.asarray(rx.residual), atol=2e-5
    )

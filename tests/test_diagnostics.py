"""SolverConfig(diagnostics=False): residual-free serving mode.

The fused dual kernel drops its w outputs, the XLA loops skip the
post-loop recovery, and SolveResult.residual/gap come back NaN; the
iterates u/z/y must be bit-identical to the diagnostics=True solve on every
engine and form. "pallas" runs the fused kernel in interpret mode
(``interpret_kernel``); the mvp forms and unpaired data have no kernel, so
"auto" resolves to the XLA loop there and a forced "pallas" is refused."""

import numpy as np
import pytest

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.solver import SolverConfig, solve_batch


@pytest.fixture(scope="module")
def qp():
    return tpu_gpad.condense(problems.battery(n_cells=3, horizon=10))


@pytest.fixture(scope="module")
def data_paired(qp):
    return tpu_gpad.dualize(qp, iterations=100, paired=True)


@pytest.fixture(scope="module")
def data_dense(qp):
    return tpu_gpad.dualize(qp, iterations=100, paired=False)


def _x0(n, n_x, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.4, 0.4, size=(n, n_x)).astype(np.float32)


def _check_pair(data, qp, base_cfg):
    import dataclasses

    X0 = _x0(6, qp.n_x, seed=4)
    full = solve_batch(data, X0, config=base_cfg)
    lite = solve_batch(
        data, X0, config=dataclasses.replace(base_cfg, diagnostics=False)
    )
    np.testing.assert_array_equal(np.asarray(lite.u), np.asarray(full.u))
    np.testing.assert_array_equal(np.asarray(lite.z), np.asarray(full.z))
    np.testing.assert_array_equal(np.asarray(lite.y), np.asarray(full.y))
    assert np.isnan(np.asarray(lite.residual)).all()
    assert np.isnan(np.asarray(lite.gap)).all()
    assert np.asarray(lite.converged).all()
    assert not np.isnan(np.asarray(full.residual)).any()


def _check_pair_or_refused(data, qp, cfg):
    """Forcing engine="pallas" where the fused kernel does not apply must
    raise, with diagnostics on or off; other engines run the pair check."""
    import dataclasses

    if cfg.engine != "pallas":
        return _check_pair(data, qp, cfg)
    for diagnostics in (True, False):
        with pytest.raises(ValueError, match="fused dual kernel"):
            solve_batch(data, _x0(2, qp.n_x),
                        config=dataclasses.replace(cfg, diagnostics=diagnostics))


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_diagnostics_off_dual_form(data_paired, qp, engine, interpret_kernel):
    _check_pair(
        data_paired, qp,
        SolverConfig(iterations=60, engine=engine, form="dual"),
    )


@pytest.mark.parametrize("engine", ["xla", "auto", "pallas"])
def test_diagnostics_off_paired_mvp(data_paired, qp, engine):
    _check_pair_or_refused(
        data_paired, qp,
        SolverConfig(iterations=60, engine=engine, form="mvp", flat="off"),
    )


@pytest.mark.parametrize("engine", ["xla", "auto", "pallas"])
def test_diagnostics_off_flat(data_paired, qp, engine):
    if data_paired.n_struct is None:
        pytest.skip("battery stack has no identity block")
    _check_pair_or_refused(
        data_paired, qp,
        SolverConfig(iterations=60, engine=engine, form="mvp", flat="on"),
    )


@pytest.mark.parametrize("engine", ["xla", "auto", "pallas"])
def test_diagnostics_off_dense(data_dense, qp, engine):
    _check_pair_or_refused(
        data_dense, qp, SolverConfig(iterations=60, engine=engine)
    )


def test_diagnostics_off_restart_dual(data_paired, qp, interpret_kernel):
    _check_pair(
        data_paired, qp,
        SolverConfig(iterations=60, engine="pallas", form="dual", restart=True),
    )


def test_diagnostics_off_warm_start_roundtrip(data_paired, qp, interpret_kernel):
    """The y from a diagnostics-off solve warm-starts the next one."""
    import dataclasses

    X0 = _x0(3, qp.n_x, seed=7)
    lite_cfg = SolverConfig(iterations=40, engine="pallas", diagnostics=False)
    full_cfg = dataclasses.replace(lite_cfg, diagnostics=True)
    first = solve_batch(data_paired, X0, config=lite_cfg)
    # warm-starting from the diagnostics-off y must be indistinguishable
    # from warm-starting from the full solve's y
    again_lite = solve_batch(data_paired, X0, config=lite_cfg, y0=first.y)
    again_full = solve_batch(
        data_paired, X0, config=full_cfg,
        y0=solve_batch(data_paired, X0, config=full_cfg).y,
    )
    np.testing.assert_array_equal(
        np.asarray(again_lite.u), np.asarray(again_full.u)
    )


def test_diagnostics_off_eps_raises(data_paired, qp):
    with pytest.raises(ValueError, match="diagnostics=False"):
        solve_batch(
            data_paired,
            _x0(2, qp.n_x),
            config=SolverConfig(mode="eps", iterations=100, diagnostics=False),
        )


def test_diagnostics_off_tiled(qp):
    """A dual past the kernel's admission (m_half=140 pads to 256 rows >
    MAX_DUAL_ROWS) takes the XLA dual loop and honors the flag too."""
    from tpu_gpad.solver import kernels
    from tpu_gpad.solver.core import resolve_engine

    qp_big = tpu_gpad.condense(problems.battery(n_cells=3, horizon=20))
    data = tpu_gpad.dualize(qp_big, iterations=100, paired=True)
    cfg = SolverConfig(iterations=50, form="dual")
    assert kernels.padded_rows(data.m_half) > kernels.MAX_DUAL_ROWS
    assert resolve_engine(data, cfg) == "xla"
    _check_pair(data, qp_big, cfg)

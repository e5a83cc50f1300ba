"""``chip_smoke.py``'s phases on the CPU at small shapes (the fused kernel
interpreted through the ``interpret_kernel`` fixture, the sharded phase on
the virtual mesh), and the script's refusal to run without a GPU. Phase
(g), the card-only tests, runs on the card only."""

import importlib.util
from pathlib import Path

import pytest

import tpu_gpad.utils.compile_cache as compile_cache
from tpu_gpad import stagewise

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture
def smoke(monkeypatch):
    # keep the test process off the persistent compile cache
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "")
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["single", "multi_gpu"])
def test_rehearsal_runs_every_phase(smoke, interpret_kernel, monkeypatch,
                                    capsys, which):
    # the small stage-wise fleet (N=40) routes stage-wise as N=200 does
    monkeypatch.setattr(stagewise, "AUTO_STAGEWISE_HORIZON", 40)
    s = smoke.Smoke(B_head=64, B_flag=4, flag=(8, 8), sw=(8, 40, 4))
    phases = ([s.multi_gpu] if which == "multi_gpu" else
              [s.phase_b, s.phase_c, s.phase_d, s.phase_e, s.phase_f])
    for phase in phases:
        phase()
    out = capsys.readouterr().out
    if which == "multi_gpu":
        assert "mesh (4x1)" in out and "mesh (2x2)" in out
        assert "engine=pallas" in out  # the (4x1) mesh runs the kernel
    else:
        for phase in ("(b)", "(c)", "(d)", "(e)", "(f)"):
            assert phase in out
        assert "engine=pallas" in out and "kind=stagewise" in out


def test_refuses_without_gpu(smoke, capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.main([])
    assert '"ok": true' not in capsys.readouterr().out

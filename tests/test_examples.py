"""Smoke-run every example script (round-2 VERDICT item 6: examples were
untested and could silently rot).

Each example runs unmodified in a fresh subprocess on CPU — the scripts
carry real behavioral asserts (the pendulum settles upright, the tube
controller respects the box, the robust controller brakes in time), so a
pass here is an end-to-end check, not just an import check. matplotlib is
blocked via ``sys.modules`` so the figure-writing blocks take their
``except ImportError`` path and the committed docs/figures stay untouched.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

EXAMPLES_DIR = Path(__file__).resolve().parent.parent / "examples"
EXAMPLES = sorted(p.name for p in EXAMPLES_DIR.glob("*.py"))

# CPU-measured budgets: the slowest (realtime_nmpc_device) takes ~10 s; a
# cold jit cache can multiply that, so the cap is generous but still fails
# a hung script well before the suite times out.
_TIMEOUT_S = 420


def _cpu_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    path = EXAMPLES_DIR / name
    driver = (
        "import sys, runpy\n"
        "sys.modules['matplotlib'] = None\n"  # import matplotlib -> ImportError
        f"sys.argv = [{str(path)!r}]\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", driver],
        capture_output=True,
        text=True,
        timeout=_TIMEOUT_S,
        env=_cpu_env(),
        cwd=EXAMPLES_DIR.parent,
    )
    assert out.returncode == 0, (
        f"{name} failed (rc={out.returncode})\n"
        f"--- stdout ---\n{out.stdout[-2000:]}\n"
        f"--- stderr ---\n{out.stderr[-2000:]}"
    )


def test_examples_discovered():
    assert len(EXAMPLES) >= 8, EXAMPLES

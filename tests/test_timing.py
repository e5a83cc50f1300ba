"""Validity gating of the interleaved A/B harness.

Under host contention a slope window can collapse to ~zero and fabricate
a huge per-round ratio. The harness must REJECT such rounds, not
aggregate them.
"""

import math

import numpy as np
import pytest

from tpu_gpad.utils.timing import _gate_ab_rounds, interleaved_ab


def _good_pairs(n=6, ta=5.0e-4, tb=5.3e-4, jitter=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (ta * (1 + jitter * rng.uniform(-1, 1)),
         tb * (1 + jitter * rng.uniform(-1, 1)))
        for _ in range(n)
    ]


def test_gate_rejects_r03_style_garbage():
    pairs = _good_pairs(6)
    # a solve slope collapsed to ~zero (an old clamp value)
    pairs.insert(3, (1e-9, 5.3e-4))
    # a contended solve window 4x slow (ratio ~0.26)
    pairs.insert(5, (2.0e-3, 5.3e-4))
    out = _gate_ab_rounds(pairs, rounds=8)
    assert out["rejected_rounds"] >= 2
    assert out["rounds"] + out["rejected_rounds"] == len(pairs)
    assert not out["unstable"]
    # no fabricated ratio survives
    assert max(out["ratios"]) < 10.0
    assert 0.9 < out["ratio_b_over_a_median"] < 1.25
    # raw ratios are still visible for post-mortems
    assert any(r > 1e5 for r in out["ratios_all"])


def test_gate_floor_marks_side_invalid():
    # floor-failed sides arrive as None (interleaved_ab applies the floor
    # before aggregation); those rounds count as rejected
    pairs = _good_pairs(5) + [(None, 5.3e-4), (5.0e-4, None)]
    out = _gate_ab_rounds(pairs, rounds=7)
    assert out["rejected_rounds"] == 2
    assert out["rounds"] == 5


def test_gate_all_garbage_is_loud_not_numeric():
    out = _gate_ab_rounds([(None, 1.0), (None, 1.0)], rounds=2)
    assert out["unstable"]
    assert out["rounds"] == 0
    assert math.isnan(out["ratio_b_over_a_median"])


def test_gate_unstable_when_too_few_valid():
    pairs = _good_pairs(2) + [(None, 1e-3)] * 6
    out = _gate_ab_rounds(pairs, rounds=8)
    assert out["unstable"]


def test_interleaved_ab_smoke_cpu():
    # end-to-end: equal workloads -> ratio near 1, all contract keys present
    import jax.numpy as jnp

    x = jnp.ones((256, 256))
    f = lambda: jnp.tanh(x @ x)
    out = interleaved_ab(f, f, rounds=3, k_large=4, min_window_s=0.01)
    for key in (
        "ratio_b_over_a_median",
        "ratios_all",
        "rejected_rounds",
        "unstable",
        "rounds_attempted",
    ):
        assert key in out
    if not out["unstable"]:
        assert 0.2 < out["ratio_b_over_a_median"] < 5.0


def test_interleaved_ab_floor_rejects_impossible_side():
    # a floor ABOVE any credible time for side B forces every round's B
    # side invalid -> loud NaN result, never a number
    import jax.numpy as jnp

    x = jnp.ones((64, 64))
    f = lambda: x + 1.0
    out = interleaved_ab(
        f, f, rounds=2, k_large=4, min_window_s=0.005, t_b_floor_s=1e9
    )
    assert out["rounds"] == 0
    assert out["unstable"]
    assert math.isnan(out["ratio_b_over_a_median"])


def test_interleaved_ab_iqr_autoscale():
    # an easy target is met in one pass; an impossible one exhausts the
    # wall budget, keeps the tightest pass, and reports the escalation
    import jax.numpy as jnp

    x = jnp.ones((256, 256))
    f = lambda: jnp.tanh(x @ x)
    out = interleaved_ab(
        f, f, rounds=3, k_large=4, min_window_s=0.01,
        iqr_rel_target=10.0, autoscale_max_s=30.0,
    )
    assert out["autoscale_passes"] == 1
    out2 = interleaved_ab(
        f, f, rounds=3, k_large=4, min_window_s=0.01,
        iqr_rel_target=1e-12, autoscale_max_s=1.0,
    )
    assert out2["autoscale_passes"] >= 1
    assert "autoscale_window_s" in out2
    if not out2["unstable"]:
        assert 0.2 < out2["ratio_b_over_a_median"] < 5.0

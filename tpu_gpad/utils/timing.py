"""Device-time measurement by the slope method.

This replaces the reference's ``gettimeofday``-around-``cudaDeviceSynchronize``
brackets (``main.cu:161-174``). A per-call host timing includes the dispatch
and the host read-back. ``device_time_per_call`` instead times K in-order
dispatches followed by one host read-back (the device executes launches in
order), for two values of K, and takes the slope — the fixed per-window
host cost cancels exactly.
"""

from __future__ import annotations

import time

import numpy as np


def _run_chain(fn, k: int) -> float:
    """Dispatch fn() k times, force completion with one host read, return s."""
    t0 = time.perf_counter()
    out = None
    for _ in range(k):
        out = fn()
    np.asarray(out.ravel()[0] if hasattr(out, "ravel") else out)
    return time.perf_counter() - t0


def device_time_per_call(
    fn,
    k_small: int = 2,
    k_large: int = 22,
    repeats: int = 3,
    min_window_s: float = 0.15,
) -> float:
    """Per-call device execution time of ``fn`` in seconds (slope method).

    ``fn`` must return a jax array whose first element forces the whole
    computation (true for any solver output). ``k_large`` is scaled up
    adaptively so the measured window is at least ``min_window_s``, long
    enough that host jitter is small against it."""
    _run_chain(fn, 2)  # warm up compile + caches
    t_probe = _run_chain(fn, k_large) / k_large
    if t_probe * (k_large - k_small) < min_window_s:
        k_large = k_small + max(int(min_window_s / max(t_probe, 1e-7)), 20)
        k_large = min(k_large, 20000)
    best = np.inf
    good = 0
    for _ in range(2 * repeats):
        if good == repeats:
            break
        t_small = _run_chain(fn, k_small)
        t_large = _run_chain(fn, k_large)
        slope = (t_large - t_small) / (k_large - k_small)
        if slope <= 0:  # a host stall hit the small window; not a timing
            continue
        best = min(best, slope)
        good += 1
    if not np.isfinite(best):  # all windows stalled
        best = t_large / k_large
    return float(max(best, 1e-9))


def device_time_stats(
    fn,
    n: int = 5,
    k_small: int = 2,
    k_large: int = 22,
    min_window_s: float = 0.15,
) -> dict:
    """Median-of-n slope-method timing with spread (the median + IQR makes
    drift vs regression distinguishable).

    A slope window whose large-minus-small difference comes out <= 0 (a
    host stall landed on the small window) is physically meaningless and
    would read as an infinite rate. Such windows are REJECTED and
    re-sampled (up to ``2n`` total attempts) and counted in
    ``rejected``. Returns ``{"median_s", "iqr_s", "n", "samples_s",
    "rejected"}``."""
    _run_chain(fn, 2)  # warm up compile + caches
    t_probe = _run_chain(fn, k_large) / k_large
    if t_probe * (k_large - k_small) < min_window_s:
        k_large = k_small + max(int(min_window_s / max(t_probe, 1e-7)), 20)
        k_large = min(k_large, 20000)
    samples = []
    rejected = 0
    for _ in range(2 * n):
        if len(samples) == n:
            break
        t_small = _run_chain(fn, k_small)
        t_large = _run_chain(fn, k_large)
        slope = (t_large - t_small) / (k_large - k_small)
        if slope <= 0:
            rejected += 1
            continue
        samples.append(slope)
    if not samples:  # every window stalled: report the stall, loudly
        samples = [max(t_large / k_large, 1e-9)]
    s = np.asarray(samples)
    q1, q3 = np.percentile(s, [25, 75])
    return {
        "median_s": float(np.median(s)),
        "iqr_s": float(q3 - q1),
        "n": int(len(samples)),
        "samples_s": [float(x) for x in s],
        "rejected": int(rejected),
        "window_calls": int(k_large - k_small),
    }


def device_time_percentiles(
    fn, n: int = 100, min_window_s: float = 0.05
) -> dict:
    """Device-side latency percentiles: ``n`` independent slope-method
    samples of per-call device time, free of the host dispatch and
    read-back a client-side p99 would include.

    MEASUREMENT SEMANTICS: each sample is a *window mean* over the
    (k_large - k_small) chained calls of one slope window, so the reported
    percentiles are of window-mean device time. Averaging inside the window
    suppresses single-call tail latency (a true per-call p99 needs per-call
    host syncs; ``wall_times`` gives those). Keys are suffixed
    ``_windowmean_s`` to keep the distinction visible; ``window_calls``
    reports the averaging width."""
    stats = device_time_stats(fn, n=n, min_window_s=min_window_s)
    s = np.asarray(stats["samples_s"])
    return {
        "p50_windowmean_s": float(np.percentile(s, 50)),
        "p90_windowmean_s": float(np.percentile(s, 90)),
        "p99_windowmean_s": float(np.percentile(s, 99)),
        "n": int(stats["n"]),
        # non-positive-slope windows (host stalls) rejected and resampled;
        # genuinely SLOW windows are kept — they ARE the measurable tail
        "rejected_windows": int(stats["rejected"]),
        "window_calls": int(stats["window_calls"]),
    }


def _sized_k_large(fn, k_small: int, k_large: int, min_window_s: float) -> int:
    t_probe = _run_chain(fn, k_large) / k_large
    if t_probe * (k_large - k_small) < min_window_s:
        k_large = k_small + max(int(min_window_s / max(t_probe, 1e-7)), 20)
        k_large = min(k_large, 20000)
    return k_large


def interleaved_ab(
    fn_a,
    fn_b,
    rounds: int = 8,
    k_small: int = 2,
    k_large: int = 22,
    min_window_s: float = 0.15,
    t_a_floor_s: float = 0.0,
    t_b_floor_s: float = 0.0,
    gate_band: float = 3.0,
    iqr_rel_target: "float | None" = None,
    autoscale_max_s: float = 120.0,
) -> dict:
    """Drift-cancelling A/B comparison: alternate slope-method windows.

    Absolute device rates drift within a session (clocks under a power
    limit, neighbours on the host), so sequential readings of A then B
    can fabricate wins. Alternating A/B windows and reporting per-round
    ratios cancels the drift — both sides see the same device state each
    round.

    VALIDITY GATING: a slope window can come out ~zero or negative under
    host contention. A round is REJECTED (never silently used) when any
    of:

    - either slope is <= 0 (stall landed on the small window);
    - either side is faster than its physical floor (``t_a_floor_s`` /
      ``t_b_floor_s``) — a faster reading is impossible, not lucky;
    - either side deviates from its own cross-round median by more than
      ``gate_band``x in either direction, or the ratio deviates from the
      cross-round median ratio by more than ``gate_band``x (medians over
      the floor-valid rounds are robust to <= half the rounds being
      garbage).

    Rejected rounds are replaced (up to ``2*rounds`` window pairs total)
    and counted in ``rejected_rounds``; ``unstable`` is set when fewer
    than ``max(3, rounds//2)`` valid rounds survive — treat the numbers
    as weather, not measurements, when it is.

    RESOLUTION AUTOSCALING: pass ``iqr_rel_target``
    (e.g. 0.10) and the measurement ESCALATES — 3x longer windows and
    more rounds per pass — until the surviving-ratio IQR/median meets the
    target or ``autoscale_max_s`` of wall clock is spent. The returned
    dict then carries ``autoscale_passes`` and ``autoscale_window_s``;
    check ``ratio_b_over_a_iqr`` against your target yourself — a result
    that still misses it after the budget is honest weather, not a
    measurement.

    Returns ``{"ratio_b_over_a_median", "ratio_b_over_a_iqr", "ratios",
    "ratios_all", "t_a_median_s", "t_b_median_s", "rounds",
    "rejected_rounds", "unstable"}``. ratio > 1 means A is faster (B
    takes longer). Both fns must return a jax array that forces the
    computation (e.g. ``res.u``, never a SolveResult)."""
    import time as _time

    t_start = _time.perf_counter()

    def one_pass(win_s, n_rounds):
        _run_chain(fn_a, 2)
        _run_chain(fn_b, 2)
        ka = _sized_k_large(fn_a, k_small, k_large, win_s)
        kb = _sized_k_large(fn_b, k_small, k_large, win_s)
        raw = []  # (ta, tb) with None for slope-invalid sides
        for attempt in range(2 * n_rounds):
            # stop when `rounds` rounds survive the FULL gate (floor +
            # band): band-rejected rounds consume attempt budget and get
            # replaced too, not just floor-rejected ones
            if (
                len(raw) >= n_rounds
                and _gate_ab_rounds(raw, n_rounds, gate_band)["rounds"]
                >= n_rounds
            ):
                break
            ta = (
                _run_chain(fn_a, ka) - _run_chain(fn_a, k_small)
            ) / (ka - k_small)
            tb = (
                _run_chain(fn_b, kb) - _run_chain(fn_b, k_small)
            ) / (kb - k_small)
            raw.append(
                (
                    ta if ta > max(t_a_floor_s, 0.0) else None,
                    tb if tb > max(t_b_floor_s, 0.0) else None,
                )
            )
        return _gate_ab_rounds(raw, n_rounds, gate_band)

    win, n_rounds, passes = min_window_s, rounds, 0
    best = None
    while True:
        res = one_pass(win, n_rounds)
        passes += 1
        med = res["ratio_b_over_a_median"]
        rel = (
            res["ratio_b_over_a_iqr"] / abs(med)
            if res["rounds"] > 0 and med
            else float("inf")
        )
        if best is None or rel < best[0]:
            best = (rel, res, win)
        if (
            iqr_rel_target is None
            or best[0] <= iqr_rel_target
            or _time.perf_counter() - t_start > autoscale_max_s
        ):
            break
        win, n_rounds = win * 3.0, max(n_rounds, rounds + 2)
    _, res, win_used = best
    if iqr_rel_target is not None:
        res["autoscale_passes"] = passes
        res["autoscale_window_s"] = win_used
    return res


def _gate_ab_rounds(raw, rounds: int, gate_band: float = 3.0) -> dict:
    """Pure gating/aggregation step of ``interleaved_ab`` (unit-testable:
    feed it raw (ta, tb) window pairs, garbage included, and assert what
    survives). ``raw`` entries use None
    for a side whose slope failed the floor/positivity check."""
    pairs = [p for p in raw if p[0] is not None and p[1] is not None]
    n_attempted = len(raw)
    if not pairs:  # hopeless weather; return a loud, unusable result
        return {
            "ratio_b_over_a_median": float("nan"),
            "ratio_b_over_a_iqr": float("nan"),
            "ratios": [],
            "ratios_all": [],
            "t_a_median_s": float("nan"),
            "t_b_median_s": float("nan"),
            "rounds": 0,
            "rounds_attempted": n_attempted,
            "rejected_rounds": n_attempted,
            "unstable": True,
        }
    t_as = np.asarray([p[0] for p in pairs])
    t_bs = np.asarray([p[1] for p in pairs])
    ratios_all = t_bs / t_as
    med_a, med_b = np.median(t_as), np.median(t_bs)
    med_r = np.median(ratios_all)
    keep = (
        (t_as > med_a / gate_band)
        & (t_as < med_a * gate_band)
        & (t_bs > med_b / gate_band)
        & (t_bs < med_b * gate_band)
        & (ratios_all > med_r / gate_band)
        & (ratios_all < med_r * gate_band)
    )
    r = ratios_all[keep]
    n_valid = int(keep.sum())
    if n_valid == 0:  # medians themselves corrupted; nothing trustworthy
        return {
            "ratio_b_over_a_median": float("nan"),
            "ratio_b_over_a_iqr": float("nan"),
            "ratios": [],
            "ratios_all": [float(x) for x in ratios_all],
            "t_a_median_s": float("nan"),
            "t_b_median_s": float("nan"),
            "rounds": 0,
            "rounds_attempted": n_attempted,
            "rejected_rounds": n_attempted,
            "unstable": True,
        }
    q1, q3 = np.percentile(r, [25, 75])
    return {
        "ratio_b_over_a_median": float(np.median(r)),
        "ratio_b_over_a_iqr": float(q3 - q1),
        "ratios": [float(x) for x in r],
        "ratios_all": [float(x) for x in ratios_all],
        "t_a_median_s": float(np.median(t_as[keep])),
        "t_b_median_s": float(np.median(t_bs[keep])),
        "rounds": n_valid,
        "rounds_attempted": n_attempted,
        "rejected_rounds": n_attempted - n_valid,
        "unstable": bool(n_valid < max(3, rounds // 2)),
    }


def matmul_peak_tflops(
    dtype: str = "float32",
    precision: str = "highest",
    size: int = 4096,
    repeats: int = 5,
) -> float:
    """Measured dense-matmul roofline on THIS chip at the given operand
    dtype/precision — the denominator for honest %-of-peak accounting
    (public spec-sheet peaks mix precisions; a (size, size)^2 matmul at the
    solver's own matmul settings is the attainable ceiling).

    Uses the MEDIAN of ``repeats`` slope-method samples: a min-of-samples
    estimate is biased fast by timing noise."""
    import jax
    import jax.numpy as jnp

    mm_dtype = jnp.dtype(dtype)
    prec = (
        jax.lax.Precision(precision.lower())
        if mm_dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    a = jnp.ones((size, size), dtype=mm_dtype)
    b = jnp.ones((size, size), dtype=mm_dtype)

    @jax.jit
    def mm(a, b):
        return jnp.matmul(
            a, b, precision=prec, preferred_element_type=jnp.float32
        )

    stats = device_time_stats(lambda: mm(a, b), n=repeats)
    return float(2 * size**3 / stats["median_s"] / 1e12)


def wall_times(fn, warmup: int = 2, iters: int = 20) -> np.ndarray:
    """End-to-end wall times per call including host dispatch and read-back
    (what a client of a serving deployment observes)."""
    for _ in range(warmup):
        out = fn()
        np.asarray(out.ravel()[0] if hasattr(out, "ravel") else out)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        np.asarray(out.ravel()[0] if hasattr(out, "ravel") else out)
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)

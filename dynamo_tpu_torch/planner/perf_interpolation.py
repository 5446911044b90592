"""Profiled-performance interpolators: what one replica can sustain.

The port's copy of ``dynamo_tpu/planner/perf_interpolation.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `components/planner/src/dynamo/planner/utils/
perf_interpolation.py:21,57` — the SLA profiler sweeps a replica offline
(TTFT vs input length for prefill; ITL vs concurrency for decode at fixed
context) and the planner interpolates those grids at plan time. On TPU the
sweep axis is chips-per-replica instead of TP×GPU, but the math is the
same. Profiles are plain dicts so `benchmarks/profile_sla.py` output and
hand-written fixtures both load.
"""

from __future__ import annotations

import numpy as np


class PrefillInterpolator:
    """TTFT (seconds) and throughput (tokens/s) vs input sequence length."""

    def __init__(self, isl_grid: list[float], ttft_s: list[float]):
        order = np.argsort(isl_grid)
        self.isl = np.asarray(isl_grid, np.float64)[order]
        self.ttft = np.asarray(ttft_s, np.float64)[order]

    def ttft_at(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.ttft))

    def throughput_at(self, isl: float) -> float:
        """Prefill tokens/s one replica sustains at this ISL."""
        return isl / max(self.ttft_at(isl), 1e-9)

    def max_isl_within(self, ttft_budget_s: float) -> float:
        """Largest ISL meeting the TTFT SLA (grid-bounded)."""
        ok = self.isl[self.ttft <= ttft_budget_s]
        return float(ok[-1]) if len(ok) else float(self.isl[0])


class DecodeInterpolator:
    """ITL (seconds/token) vs concurrency; per-replica decode capacity."""

    def __init__(self, concurrency_grid: list[float], itl_s: list[float]):
        order = np.argsort(concurrency_grid)
        self.conc = np.asarray(concurrency_grid, np.float64)[order]
        self.itl = np.asarray(itl_s, np.float64)[order]

    def itl_at(self, concurrency: float) -> float:
        return float(np.interp(concurrency, self.conc, self.itl))

    def max_concurrency_within(self, itl_budget_s: float) -> float:
        ok = self.conc[self.itl <= itl_budget_s]
        return float(ok[-1]) if len(ok) else float(self.conc[0])

    def throughput_at(self, concurrency: float) -> float:
        """Decode tokens/s one replica sustains at this concurrency."""
        return concurrency / max(self.itl_at(concurrency), 1e-9)


def from_profile(profile: dict) -> tuple[PrefillInterpolator, DecodeInterpolator]:
    """Load from profiler output: {'prefill': {'isl': [...], 'ttft_s': [...]},
    'decode': {'concurrency': [...], 'itl_s': [...]}}."""
    return (
        PrefillInterpolator(profile["prefill"]["isl"], profile["prefill"]["ttft_s"]),
        DecodeInterpolator(profile["decode"]["concurrency"], profile["decode"]["itl_s"]),
    )

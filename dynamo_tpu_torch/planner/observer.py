"""Live observation source for the SLA planner: the frontend's
Prometheus endpoint.

The port's copy of ``dynamo_tpu/planner/observer.py``, held to it by
``tests/test_torch_copies.py``.

Closes the observe half of the reference's adjustment loop
(`components/planner/src/dynamo/planner/utils/planner_core.py:180`
`observe_metrics` — it scrapes the frontend's TTFT/ITL histograms and
request counters from Prometheus; here the planner scrapes the frontend
directly, no Prometheus server in between).

Each call to :meth:`observe` diffs the current counter/histogram totals
against the previous scrape, turning cumulative series into one
adjustment window's :class:`Observation`.
"""

from __future__ import annotations

import logging
import re
import time

import aiohttp

from dynamo_tpu_torch.planner.planner_core import Observation

log = logging.getLogger("dynamo_tpu.planner.observer")

# Metric families emitted by llm/http_service.py (dynamo_frontend_*).
_REQS = "dynamo_frontend_requests_total"
_TTFT = "dynamo_frontend_time_to_first_token_seconds"
_ITL = "dynamo_frontend_inter_token_latency_seconds"
_ISL = "dynamo_frontend_input_sequence_tokens"
_OSL = "dynamo_frontend_output_sequence_tokens"
# Per-phase latency histograms from the tracer (dynamo_tpu/tracing):
# the measured TTFT/ITL decomposition (tokenize/route/prefill/decode...).
_PHASE = "dynamo_trace_phase_duration_seconds"
_PHASE_LABEL_RE = re.compile(r'phase="([^"]+)"')


def parse_prometheus(text: str) -> dict[str, float]:
    """Sum every sample of each metric family (labels collapsed) AND keep
    every labeled sample addressable under its full ``name{labels}`` key,
    exactly as written on the wire. The family total is what the rate/ISL
    diff math wants; the labeled keys are what the closed-loop controller
    wants — per-worker (``{...worker_id="7"...}``) and per-tenant
    (``{...tenant="acme"...}``) series read directly, without the
    aggregator's rollups collapsing them. Two spellings of the same
    series sum (a family name never contains ``{``, so labeled keys can
    never collide with family totals).

    The tracer's per-phase histograms additionally keep their historical
    phase-only keys (``{family}_sum{{phase}}``) so
    :meth:`MetricsObserver.observe` can decompose TTFT/ITL by phase."""
    totals: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value = line.rsplit(None, 1)
        except ValueError:
            continue
        name = name_part.split("{", 1)[0]
        try:
            v = float(value)
        except ValueError:
            continue
        totals[name] = totals.get(name, 0.0) + v
        if "{" in name_part:
            # The labeled sample stays addressable verbatim.
            totals[name_part] = totals.get(name_part, 0.0) + v
        if name.startswith(_PHASE) and name != f"{_PHASE}_bucket":
            m = _PHASE_LABEL_RE.search(name_part)
            if m:
                key = f"{name}{{{m.group(1)}}}"
                totals[key] = totals.get(key, 0.0) + v
    return totals


class MetricsObserver:
    """Scrapes ``{base_url}/metrics`` and produces per-window Observations."""

    def __init__(self, base_url: str):
        self.url = base_url.rstrip("/") + "/metrics"
        self._prev: dict[str, float] | None = None
        self._prev_t: float = 0.0
        self._last_means = (256.0, 128.0)  # (isl, osl) fallback before traffic

    async def _scrape(self) -> dict[str, float]:
        async with aiohttp.ClientSession() as s:
            async with s.get(self.url) as r:
                r.raise_for_status()
                return parse_prometheus(await r.text())

    async def observe(self) -> Observation:
        now = time.monotonic()
        cur = await self._scrape()
        prev, prev_t = self._prev, self._prev_t
        self._prev, self._prev_t = cur, now
        if prev is None:
            return Observation(request_rate=0.0, mean_isl=self._last_means[0],
                               mean_osl=self._last_means[1])

        window = max(now - prev_t, 1e-6)

        def delta(name: str) -> float:
            return max(0.0, cur.get(name, 0.0) - prev.get(name, 0.0))

        n_req = delta(_REQS)
        rate = n_req / window

        def mean(family: str, fallback: float) -> float:
            c = delta(f"{family}_count")
            return delta(f"{family}_sum") / c if c > 0 else fallback

        isl = mean(_ISL, self._last_means[0])
        osl = mean(_OSL, self._last_means[1])
        self._last_means = (isl, osl)
        ttft_c = delta(f"{_TTFT}_count")
        itl_c = delta(f"{_ITL}_count")

        # Measured per-phase decomposition over the window: mean seconds
        # spent in each tracer phase (tokenize/route/prefill/decode/...),
        # from the dynamo_trace_phase_duration_seconds{phase=...} series.
        phase_means: dict[str, float] = {}
        prefix = f"{_PHASE}_count{{"
        for key in cur:
            if not key.startswith(prefix):
                continue
            phase = key[len(prefix):-1]
            c = delta(key)
            if c > 0:
                phase_means[phase] = delta(f"{_PHASE}_sum{{{phase}}}") / c

        return Observation(
            request_rate=rate,
            mean_isl=isl,
            mean_osl=osl,
            observed_ttft_s=(delta(f"{_TTFT}_sum") / ttft_c) if ttft_c else None,
            observed_itl_s=(delta(f"{_ITL}_sum") / itl_c) if itl_c else None,
            phase_means=phase_means or None,
        )


class FleetMetricsObserver:
    """The event-plane observation source (ISSUE 13): the planner reads
    the fleet aggregator's composed state instead of point-scraping one
    frontend's /metrics. Same per-window diff math as
    :class:`MetricsObserver` (it lives in
    ``obs/aggregator.FleetAggregator.observation``), but fed by metric
    snapshots from LIVE workers only — a dead worker's counters leave
    the aggregate the moment its series retire, so the planner never
    plans against ghosts."""

    def __init__(self, aggregator):
        self.aggregator = aggregator

    async def observe(self) -> Observation:
        return self.aggregator.observation()

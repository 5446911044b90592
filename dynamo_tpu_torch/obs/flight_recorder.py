"""Crash/stall flight recorder: a bounded ring of engine-step records.

The port's copy of ``dynamo_tpu/obs/flight_recorder.py``, held to it by
``tests/test_torch_copies.py``.

Every engine (real EngineCore and the mocker) appends one compact record
per committed step — step shape, lane cursors, dispatch/commit
timestamps, cumulative shed counters — into a fixed-size ring. The hot
path is ONE dict build + ONE ``deque.append`` (atomic under the GIL, no
host sync, no lock): cheap enough to stay on by default, bounded enough
to never grow.

On a terminal event the ring is dumped to a REDACTED JSON artifact — the
post-mortem the chaos harness (PR 6) could never produce: a killed
worker's final megasteps are reconstructable from the artifact alone.
Dump triggers (each names the artifact's ``reason``):

- ``sigterm_drain``   — graceful drain (DistributedRuntime.drain)
- ``chaos_kill``      — a ChaosKill landed in an engine loop
- ``stall_deadline``  — a response-stream stall deadline fired
  (dataplane ``_note_stall``); in single-process deployments this also
  captures the wedged engine's ring, since a dump flushes EVERY recorder
  registered in the process
- ``breaker_open``    — a dataplane circuit breaker opened

Redaction: artifacts carry counts, cursors, ids, and timestamps — never
token values or prompt/content text. The dump pass strips any key in
:data:`REDACT_KEYS` recursively and truncates long strings, so a record
accidentally carrying payload can not leak it into the artifact.

Knobs (env):

- ``DYN_FLIGHT_STEPS`` — ring capacity in records (default 256; 0
  disables recording entirely — ``record_step`` returns immediately).
- ``DYN_FLIGHT_DIR``   — artifact directory (default
  ``$TMPDIR/dynamo_flight``).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import tempfile
import time
import weakref
from collections import deque
from typing import Any

from dynamo_tpu_torch import knobs

log = logging.getLogger("dynamo_tpu.obs.flight")

# Keys stripped recursively from every dumped record: the artifact must
# never carry token values or user text, only shapes/cursors/timestamps.
REDACT_KEYS = frozenset(
    {"token_ids", "logprobs", "text", "prompt", "content", "messages"}
)

# Longest string value a dumped record may carry (ids/reasons fit well
# under this; anything longer is suspect payload and is truncated).
_MAX_STR = 256

# Per-reason dump budget: a flapping breaker must not fill the disk with
# artifacts. After this many dumps for one reason, further triggers only
# log. A per-reason cooldown also coalesces bursts.
_MAX_DUMPS_PER_REASON = 8
_DUMP_COOLDOWN_S = 1.0


def _env_capacity() -> int:
    return max(0, knobs.get_int("DYN_FLIGHT_STEPS"))


def artifact_dir() -> str:
    return knobs.get_str("DYN_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "dynamo_flight"
    )


class FlightRecorder:
    """One engine's bounded step-record ring.

    ``record_step``/``record_event`` are hot-path safe (single append);
    registration is global so a process-wide dump trigger (drain, stall,
    breaker) flushes every live engine's ring at once. Held weakly by
    the registry: an engine garbage-collected between dumps unregisters
    itself.
    """

    def __init__(self, name: str, capacity: int | None = None):
        self.name = name
        self.capacity = _env_capacity() if capacity is None else max(0, capacity)
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(1, self.capacity))
        self.started_at = time.time()
        _register(self)

    def record_step(self, **fields: Any) -> None:
        """One committed engine step. No-op at capacity 0. Fields are
        host-resident scalars/lists only — callers must never pass device
        arrays (this is an append, not a sync point)."""
        if self.capacity == 0:
            return
        fields["t"] = time.time()
        fields.setdefault("kind", "step")
        self._ring.append(fields)

    def record_event(self, event: str, **fields: Any) -> None:
        """A discrete non-step event (shed, deadline expiry, breaker
        trip) interleaved into the same ring in arrival order."""
        if self.capacity == 0:
            return
        fields["t"] = time.time()
        fields["kind"] = "event"
        fields["event"] = event
        self._ring.append(fields)

    def snapshot(self) -> list[dict[str, Any]]:
        # The ring is appended from the engine thread while dump triggers
        # read from the event loop / drain thread; a copy that catches a
        # concurrent append raises RuntimeError — retry, the copy is
        # microseconds and the collision window one append.
        for _ in range(8):
            try:
                return list(self._ring)
            except RuntimeError:
                continue
        return []

    def clear(self) -> None:
        self._ring.clear()


# ---------------------------------------------------------------------------
# Process-global registry + dump triggers
# ---------------------------------------------------------------------------

_ids = itertools.count(1)
_recorders: "weakref.WeakValueDictionary[int, FlightRecorder]" = (
    weakref.WeakValueDictionary()
)
_dumps_by_reason: dict[str, int] = {}
_last_dump_at: dict[str, float] = {}


def _register(rec: FlightRecorder) -> None:
    _recorders[next(_ids)] = rec


def enabled() -> bool:
    """Cheap guard for trigger sites: False when nothing is recording."""
    return len(_recorders) > 0


def redact(obj: Any) -> Any:
    """Strip payload-bearing keys and truncate long strings, recursively.
    The dump's privacy contract: counts/cursors/ids stay, values go."""
    if isinstance(obj, dict):
        return {
            k: redact(v) for k, v in obj.items() if k not in REDACT_KEYS
        }
    if isinstance(obj, (list, tuple)):
        return [redact(v) for v in obj]
    if isinstance(obj, str) and len(obj) > _MAX_STR:
        return obj[:_MAX_STR] + "...[truncated]"
    return obj


def reset_budget() -> None:
    """Test hook: forget per-reason dump budgets/cooldowns."""
    _dumps_by_reason.clear()
    _last_dump_at.clear()


def reset_registry() -> None:
    """Test hook: drop every registered recorder. A process-wide dump
    flushes EVERY live ring by design, so tests that assert on artifact
    counts must first clear recorders leaked by earlier fixtures (the
    registry is weak, but test engines often stay referenced)."""
    _recorders.clear()


def dump_all(reason: str, detail: str = "") -> list[str]:
    """Write every registered recorder's ring to one artifact each;
    returns the paths. Synchronous file I/O — trigger sites are failure
    paths (drain, stall, kill), never the step loop; async callers that
    care hop through ``asyncio.to_thread``. Budgeted per reason so a
    flapping trigger cannot fill the disk."""
    if not enabled():
        return []
    now = time.monotonic()
    if now - _last_dump_at.get(reason, -_DUMP_COOLDOWN_S) < _DUMP_COOLDOWN_S:
        return []
    if _dumps_by_reason.get(reason, 0) >= _MAX_DUMPS_PER_REASON:
        log.warning("flight dump budget exhausted for reason %r", reason)
        return []
    _last_dump_at[reason] = now
    _dumps_by_reason[reason] = _dumps_by_reason.get(reason, 0) + 1
    out_dir = artifact_dir()
    try:
        os.makedirs(out_dir, exist_ok=True)
    except OSError:
        log.exception("flight dump dir %r not writable", out_dir)
        return []
    paths: list[str] = []
    stamp = int(time.time() * 1e3)
    for rec in list(_recorders.values()):
        records = rec.snapshot()
        if not records:
            continue
        payload = {
            "schema": 1,
            "reason": reason,
            "detail": detail,
            "recorder": rec.name,
            "pid": os.getpid(),
            "dumped_at": time.time(),
            "recorder_started_at": rec.started_at,
            "capacity": rec.capacity,
            "records": redact(records),
        }
        fname = f"flight-{os.getpid()}-{rec.name}-{reason}-{stamp}.json"
        path = os.path.join(out_dir, fname)
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, separators=(",", ":"))
            os.replace(tmp, path)  # crash-safe like DiskKvPool.put
            paths.append(path)
        except OSError:
            log.exception("flight dump write failed (%s)", path)
    if paths:
        log.warning(
            "flight recorder: dumped %d artifact(s) for %r -> %s",
            len(paths), reason, out_dir,
        )
    return paths

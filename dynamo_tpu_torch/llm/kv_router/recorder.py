"""KV-event recorder/replayer: capture router event streams to JSONL and
replay them for offline analysis or index reconstruction.

The port's copy of ``dynamo_tpu/llm/kv_router/recorder.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/llm/src/kv_router/recorder.rs` +
`recorder.rs:667` (JSONL record/replay) — powers router debugging and the
route-quality analysis workflow without a live cluster.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Iterator

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent


def _event_to_json(event: RouterEvent) -> dict:
    return {
        "w": event.worker_id,
        "i": event.event_id,
        "op": event.event.op,
        "h": list(event.event.block_hashes),
        "p": event.event.parent_hash,
    }


def _event_from_json(d: dict) -> RouterEvent:
    return RouterEvent(
        worker_id=d["w"],
        event_id=d["i"],
        event=KvCacheEvent(op=d["op"], block_hashes=tuple(d["h"]), parent_hash=d["p"]),
    )


class KvEventRecorder:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None
        self.recorded = 0

    def __enter__(self) -> "KvEventRecorder":
        self._fh = open(self.path, "a")
        return self

    def __exit__(self, *exc) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def record(self, event: RouterEvent, ts: float | None = None) -> None:
        assert self._fh is not None, "use as a context manager"
        line = {"ts": ts if ts is not None else time.time(), "event": _event_to_json(event)}
        self._fh.write(json.dumps(line) + "\n")
        self.recorded += 1

    def attach(self, indexer) -> Callable[[RouterEvent], None]:
        """Tap: returns a callback that records then forwards to the
        indexer's tree."""

        def tap(event: RouterEvent) -> None:
            self.record(event)
            indexer.tree.apply_event(event)

        return tap


def replay_events(path: str | Path) -> Iterator[tuple[float, RouterEvent]]:
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            yield obj["ts"], _event_from_json(obj["event"])


def replay_into(path: str | Path, tree) -> int:
    """Rebuild an index from a recording; returns events applied."""
    n = 0
    for _, event in replay_events(path):
        tree.apply_event(event)
        n += 1
    return n

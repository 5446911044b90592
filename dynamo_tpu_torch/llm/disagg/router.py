"""Conditional disaggregation: local vs remote prefill decision.

The port's copy of ``dynamo_tpu/llm/disagg/router.py``, held to it by
``tests/test_torch_copies.py``.

A decode worker sends a request's prefill to the prefill fleet only when
it is long enough to be worth the KV transfer AND the prefill fleet isn't
backed up — otherwise prefilling locally is faster. Thresholds hot-reload
from the control-plane store so operators can tune a live system.

Control-plane degradation: while the store is dark,
the router serves its LAST-KNOWN-GOOD policy. Key deletions that arrive
around a blackout — lease revokes as the connection dies, or events
drained from the subscription queue after the session already dropped —
are blackout artifacts, not operator intent, and are DEFERRED: the policy
keeps its last value until a post-reconnect event re-asserts authority
(the replayed watch's initial snapshot does exactly that). Only an
explicit delete observed on a live session reverts to defaults.

Capability parity: reference `lib/llm/src/disagg_router.rs:24-100`
(prefill-length + queue-depth conditions, etcd-watched config) and
`docs/architecture/disagg_serving.md:46-56`.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass

from dynamo_tpu_torch import tracing

log = logging.getLogger("dynamo_tpu.disagg")

DISAGG_CONFIG_KEY = "/dynamo/config/disagg/{namespace}"


@dataclass
class DisaggConfig:
    # Prefills at or below this many uncached tokens stay local.
    max_local_prefill_length: int = 50
    # Remote prefill is skipped while the prefill queue is deeper than this.
    max_prefill_queue_size: int = 2
    enabled: bool = True


class DisaggRouter:
    def __init__(self, config: DisaggConfig | None = None):
        self.config = config or DisaggConfig()
        # Disagg-phase spans (the decision here; prefill_handoff /
        # kv_transfer recorded by the decode worker around the actual
        # queue round-trip and block pull) share this tracer.
        self.tracer = tracing.get_tracer("disagg")
        # Policy flips deferred because the store was dark (or the delete
        # was a lease/conn-death artifact) when they arrived. Observable
        # so the blackout A/B can pin the behavior.
        self.deferred_resets = 0

    def should_remote_prefill(
        self, prefill_length: int, queue_depth: int = 0
    ) -> bool:
        """``prefill_length`` = tokens actually needing prefill (prompt
        minus the locally cached prefix)."""
        c = self.config
        return (
            c.enabled
            and prefill_length > c.max_local_prefill_length
            and queue_depth <= c.max_prefill_queue_size
        )

    def decide(
        self,
        prefill_length: int,
        queue_depth: int = 0,
        headers: dict[str, str] | None = None,
        request_id: str | None = None,
    ) -> bool:
        """`should_remote_prefill` + a span attributing the decision (and
        its inputs) to the request's trace."""
        t0 = time.time()
        remote = self.should_remote_prefill(prefill_length, queue_depth)
        self.tracer.record(
            "disagg_decision", t0, time.time(), headers=headers,
            attrs={
                "request_id": request_id,
                "prefill_length": prefill_length,
                "queue_depth": queue_depth,
                "remote": remote,
            },
        )
        return remote

    def apply_watch_event(self, event, connected: bool = True) -> bool:
        """Fold one config-key watch event into the live policy. Returns
        True when the policy changed. Split from :meth:`watch_store` so
        the degradation contract is testable without a store.

        Puts always apply — they carry the operator's data regardless of
        when they were drained. Deletes revert to defaults ONLY when they
        are explicit retractions observed on a live session; a delete
        with a lease/conn-death reason, or one drained while the store is
        dark, is a blackout artifact and defers (last-known-good wins
        until the reconnect replay re-asserts the key's true state)."""
        if event.type == "put" and event.value is not None:
            try:
                self.config = DisaggConfig(**json.loads(event.value))
                log.info("disagg config reloaded: %s", self.config)
                return True
            except (ValueError, TypeError) as e:
                log.warning("bad disagg config at %s: %s", event.key, e)
            return False
        if event.type == "delete":
            if not connected or event.reason == "lease":
                self.deferred_resets += 1
                log.warning(
                    "deferring disagg policy reset (store dark or lease "
                    "revoke); keeping last-known-good %s", self.config,
                )
                return False
            self.config = DisaggConfig()
            log.info("disagg config key deleted; reverting to defaults")
            return True
        return False

    async def watch_store(self, store, namespace: str) -> None:
        """Follow config updates at DISAGG_CONFIG_KEY (hot reload). The
        subscription survives store blackouts (the client replays watches
        with their initial snapshot on reconnect); events drained around
        an outage go through :meth:`apply_watch_event`'s deferral rules."""
        from dynamo_tpu_torch.runtime.store.client import StoreClient

        key = DISAGG_CONFIG_KEY.format(namespace=namespace)
        sub = await store.kv_watch(key)
        async for ev in sub:
            event = StoreClient.as_watch_event(ev)
            self.apply_watch_event(event, connected=store.connected)

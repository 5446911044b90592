"""Leader/follower step replication: the ranks of a mesh in lockstep.

Counterpart of ``dynamo_tpu/backends/jax/multihost.py``, with the same
journal design. A PyTorch process drives one card, so a mesh of tp or dp
ranks, of pp stages or of sp ranks is that many processes even on one
node (``--tp``, ``--dp``, ``--pp``, ``--sp``), as it is across nodes
(``--nnodes``): every rank must run the same forwards in the same order,
since each forward calls collectives (and a pipeline's stage hops) that
every rank joins. Every rank runs the same scheduler; only its forward
differs (its heads, its lane block or its layers). An sp rank's paged
forwards call no collective, so its follower may run behind the leader
until a ring prefill, whose exchanges every rank joins in the same step. The scheduler is deterministic given an
identical op stream (sampling reads logits that are identical on every
rank: gathered over tp, gathered lane blocks over dp, the exit broadcast
and vocab gather of a pipeline; with seeds that derive from the request
counter), so lockstep reduces to replicating the *intake*:

- the leader (rank 0) serves the worker's endpoints; before each
  ``step()`` it publishes the ops applied since the previous step
  (requests added, cancels observed, cache clears) on a store subject;
- the followers replay each record (:func:`apply_record`), then call
  ``step()`` and discard its outputs, so they run the same forwards in
  the same order. The collectives are the synchronization: a leader step
  blocks until every follower reaches it.

A store-backed barrier (``runtime/barrier.py``) gates start-up so that no
follower misses the first record.

Out of scope under a mesh (refused loudly, ``ROADMAP.md`` A12d):
embeddings (a second family of forwards whose order relative to steps is
not replicated), disaggregated block import and export, and wall-clock
hold expiry (``held_block_ttl_s`` is forced to 0), as in the JAX package.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
from typing import Any

import msgpack

from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

log = logging.getLogger("dynamo_tpu_torch.backends.torch.multihost")


def steps_subject(namespace: str, component: str) -> str:
    return f"mh_steps:{namespace}:{component}"


def barrier_name(namespace: str, component: str) -> str:
    return f"mh_start:{namespace}:{component}"


class LeaderCore(EngineCore):
    """EngineCore that journals intake and publishes one record per step.

    Lockstep invariant: the scheduler may only observe state changes that
    the step record journals. Three mechanisms enforce it:

    - **Staged intake.** ``_enqueue`` diverts validated sequences to a
      staging deque instead of the scheduler inbox; the step snapshot
      (atomically, under ``_mh_mutex``) journals them and moves them to
      the real inbox. An add landing mid-step therefore cannot be
      admitted before its record exists.
    - **Deferred cancels.** ``cancel_request`` marks a pending flag; the
      snapshot promotes it to ``seq.cancelled`` and a journal op. The
      scheduler reads ``cancelled`` live, so the flag must not flip
      between snapshot and execution.
    - **Journal-then-validate adds.** The add op is journaled BEFORE
      ``add_request`` validation: a rejected request (which already
      consumed a request-counter tick, from which seeds derive) replays
      on followers as the same rejection, keeping counters aligned.

    ``publish(record)`` must be thread-safe (``step()`` runs on a worker
    thread); the worker wires it to the event loop with
    ``call_soon_threadsafe``, FIFO, so records arrive in order."""

    def __init__(self, *args, publish=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._mh_publish = publish
        self._mh_mutex = threading.Lock()
        self._mh_ops: list[dict] = []
        self._mh_stage: collections.deque = collections.deque()
        self._mh_iter = 0
        self._mh_known: dict[str, Any] = {}  # rid -> seq (cancel tracking)
        # Wall-clock overload state would desynchronize leader and
        # followers (deadline expiry fires at different instants; the
        # bounded queue's length differs between staged and direct
        # intake): forced off, like held_block_ttl_s.
        self.enforce_deadlines = False
        self._max_waiting = 0

    def add_request(self, pre: PreprocessedRequest):
        with self._mh_mutex:
            self._mh_ops.append({"op": "add", "req": pre.to_wire()})
            seq = super().add_request(pre)  # on raise the op stays: the
            # follower replays the identical rejection (counter parity)
            self._mh_known[seq.request_id] = seq
            return seq

    def _enqueue(self, seq) -> None:
        # The caller (add_request) holds _mh_mutex.
        self._mh_stage.append(seq)

    def has_work(self) -> bool:
        # Staged intake must wake the engine loop (it reaches the real
        # inbox only at the next step's snapshot).
        return bool(self._mh_stage) or super().has_work()

    def cancel_request(self, seq) -> None:
        seq.mh_cancel_pending = True  # promoted at the next snapshot

    def clear_kv_cache(self) -> int:
        # Journal and execute atomically against the snapshot (both take
        # _mh_mutex) and against steps (_step_lock).
        with self._step_lock:
            with self._mh_mutex:
                self._mh_ops.append({"op": "clear"})
            return len(self.allocator.clear_cache())

    def embed(self, token_ids):
        raise ValueError(
            "embeddings on a lockstep (tensor-parallel) engine are not ported yet: "
            "their forwards' order cannot be replicated to followers (ROADMAP.md A12d)"
        )

    def step(self):
        with self._step_lock, self._on_stream():
            with self._mh_mutex:
                ops = self._mh_ops
                self._mh_ops = []
                while self._mh_stage:
                    self._inbox.append(self._mh_stage.popleft())
                done = []
                for rid, seq in self._mh_known.items():
                    # Finish wins: the facade sets the cancel flag in its
                    # finally for every completed stream, and a journaled
                    # cancel for a finished request would make every
                    # follower scan for a sequence that no longer exists.
                    if seq.finish is not None and rid not in self._held:
                        done.append(rid)
                    elif getattr(seq, "mh_cancel_pending", False) and not seq.cancelled:
                        seq.cancelled = True
                        ops.append({"op": "cancel", "rid": rid})
                        done.append(rid)
                for rid in done:
                    self._mh_known.pop(rid, None)
                record = {"iter": self._mh_iter, "ops": ops}
                self._mh_iter += 1
            if self._mh_publish is not None:
                self._mh_publish(record)
            return self._step_locked()


def follower_mode(core: EngineCore) -> None:
    """Mirror the leader's overload gating (``LeaderCore.__init__``): a
    follower must never expire or refuse what the leader admitted."""
    core.enforce_deadlines = False
    core._max_waiting = 0


def apply_record(core: EngineCore, record: dict) -> None:
    """Apply one step record's ops to a follower's core (the step itself
    is the caller's): adds (a rejected one is rejected again, which keeps
    the request counter aligned), cancels and cache clears."""
    for op in record["ops"]:
        kind = op["op"]
        if kind == "add":
            try:
                core.add_request(PreprocessedRequest.from_wire(op["req"]))
            except ValueError:
                # The leader journaled this add BEFORE validating and
                # rejected it the same way.
                pass
        elif kind == "cancel":
            for seq in (*core.running, *core.waiting, *core._inbox):
                if seq.request_id == op["rid"]:
                    seq.cancelled = True
        elif kind == "clear":
            core.clear_kv_cache()


async def run_follower(
    runtime,
    core: EngineCore,
    namespace: str,
    component: str,
    num_processes: int,
    ready_event: asyncio.Event | None = None,
) -> None:
    """Follower loop: replay the leader's step records until cancelled.

    Subscribes BEFORE checking into the start-up barrier, so record 0
    cannot be missed; the leader waits on the same barrier before its
    first step. A gap in the records raises: a follower out of step
    would deadlock the mesh's collectives."""
    from dynamo_tpu_torch.runtime.barrier import WorkerBarrier

    follower_mode(core)
    sub = await runtime.store.subscribe(steps_subject(namespace, component))
    # Lease-bound check-in: a dead follower's key vanishes with its
    # lease, so a restart cannot satisfy the new leader's barrier with
    # the previous run's stale check-ins.
    await WorkerBarrier(
        runtime.store,
        barrier_name(namespace, component),
        worker_id=str(runtime.primary_lease_id),
    ).sync(timeout=600.0, lease=runtime.primary_lease_id)
    if ready_event is not None:
        ready_event.set()
    log.info("lockstep follower ready (%s/%s, %d ranks)", namespace, component, num_processes)
    expected = 0
    async for msg in sub:
        record = msgpack.unpackb(msg["p"], raw=False)
        if record["iter"] != expected:
            raise RuntimeError(
                f"step record gap: expected iter {expected}, got {record['iter']}: "
                "the follower lost lockstep"
            )
        expected += 1
        apply_record(core, record)
        # The step runs the leader's forwards in the leader's order; the
        # collectives inside block until every rank arrives.
        await asyncio.to_thread(core.step)

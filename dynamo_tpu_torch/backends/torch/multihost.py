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

The engine's other collective methods (``engine/core.py``: reading held
or cached pages, importing pages, embeddings) run in the same order on
every rank too: the leader's call stages the op and waits; the next
step's snapshot journals it after that step's intake, and runs it on the
engine thread before the step's forwards, so that its page collectives
never interleave with a forward's on the process group; a follower runs
it where its record says, before its step, and the next record says how
the leader's ended (a follower whose replay ended otherwise has lost
lockstep, and stops). The page bytes travel through
the collectives (``parallel/comm.page_gather``/``page_scatter``), never
in a record. Releases of held blocks are journaled as they happen, and
held-block expiry is the leader's decision on its own clock, journaled
as releases. Descriptors, chunk cursors and prefix probes read host
state that every rank holds alike, and run on the leader alone.

Across nodes (``--nnodes``) the worker keeps the JAX package's refusals:
the aggregated role only, ``held_block_ttl_s`` 0, no embeddings
(``multihost=True``), and no peer page serving.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
from concurrent.futures import Future
from typing import Any, Callable

import msgpack

from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime import wire

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
    ``call_soon_threadsafe``, FIFO, so records arrive in order.

    The collective methods (:meth:`read_held_pages`,
    :meth:`read_cached_pages`, :meth:`import_blocks`, :meth:`embed`) stage
    a job and block on its future; ``wake()``, where the caller sets it
    (thread-safe), tells the engine loop there is a job to step for. They must not be called from
    the thread that runs ``step()``. ``multihost`` (ranks across nodes)
    refuses embeddings, as the JAX package's multi-host engine does."""

    def __init__(self, *args, publish=None, multihost: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self._mh_publish = publish
        self.wake: Callable[[], None] | None = None
        self._multihost = multihost
        self._mh_mutex = threading.Lock()
        self._mh_ops: list[dict] = []
        self._mh_stage: collections.deque = collections.deque()
        # Staged collective jobs: (op, run, future), run by the next step.
        self._mh_jobs: list[tuple[dict, Callable[[], Any], Future]] = []
        self._mh_closed = False
        # How the previous record's jobs ended, journaled in the next.
        self._mh_outcomes: list[str] = []
        self._mh_iter = 0
        self._mh_known: dict[str, Any] = {}  # rid -> seq (cancel tracking)
        # Wall-clock overload state would desynchronize leader and
        # followers (deadline expiry fires at different instants; the
        # bounded queue's length differs between staged and direct
        # intake): forced off. Held-block expiry is the snapshot's.
        self.enforce_deadlines = False
        self._max_waiting = 0
        self.expire_holds = False

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
        # Staged intake and jobs must wake the engine loop (they reach the
        # inbox and run only at the next step's snapshot).
        return bool(self._mh_stage) or bool(self._mh_jobs) or super().has_work()

    def cancel_request(self, seq) -> None:
        seq.mh_cancel_pending = True  # promoted at the next snapshot

    def clear_kv_cache(self) -> int:
        # Journal and execute atomically against the snapshot (both take
        # _mh_mutex) and against steps (_step_lock).
        with self._step_lock:
            with self._mh_mutex:
                self._mh_ops.append({"op": "clear"})
            return len(self.allocator.clear_cache())

    def _job(self, op: dict, run: Callable[[], Any]) -> Any:
        """Stage ``op`` for the next step's snapshot, which journals it and
        calls ``run()`` on the engine thread under the step lock; returns
        what ``run`` returned (or raises what it raised)."""
        fut: Future = Future()
        with self._mh_mutex:
            if self._mh_closed:
                raise RuntimeError("the lockstep leader has stopped stepping")
            self._mh_jobs.append((op, run, fut))
        if self.wake is not None:
            self.wake()
        return fut.result()

    def close(self) -> None:
        """Stop taking jobs and fail those still staged (their callers would
        otherwise wait for a step that never comes)."""
        with self._mh_mutex:
            self._mh_closed = True
            jobs, self._mh_jobs = self._mh_jobs, []
        for _, _, fut in jobs:
            fut.set_exception(RuntimeError("the lockstep leader has stopped stepping"))

    def release_held(self, request_id: str) -> None:
        with self._step_lock:
            with self._mh_mutex:
                self._mh_ops.append({"op": "release", "rid": request_id})
            self._release_held_locked(request_id)

    def read_held_pages(self, request_id: str, start: int, count: int) -> list[bytes]:
        pages, n = self._job({"op": "read_held", "rid": request_id, "start": start,
                              "count": count},
                             lambda: self._held_pages(request_id, start, count))
        return self._fetch_page_bytes(pages, n) if pages is not None else []

    def read_cached_pages(self, hashes: list[int]) -> list[bytes]:
        hashes = list(hashes)
        out = self._job({"op": "read_cached", "hashes": hashes},
                        lambda: self._cached_pages(hashes))
        return out() if out is not None else []

    def import_blocks(self, blocks: list[dict]):
        staged = self._stage_imports(blocks)  # a refusal raises here, journaled nowhere
        descs = [{k: v for k, v in b.items() if k != wire.IMP_KV} for b in blocks]
        return self._job({"op": "import", "blocks": descs},
                         lambda: self._import_locked(descs, staged))

    def embed(self, token_ids):
        if self._multihost:
            raise RuntimeError(
                "embeddings are not supported on a multi-host engine yet "
                "(their program order cannot be replicated to followers)"
            )
        tokens = [int(t) for t in token_ids]
        self._check_embed(tokens)
        return self._job({"op": "embed", "tokens": tokens},
                         lambda: self._embed_locked(tokens))

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
                # Held-block expiry on the leader's clock, journaled.
                for rid in self._expired_holds():
                    ops.append({"op": "release", "rid": rid})
                    self._expire_hold(rid)
                jobs, self._mh_jobs = self._mh_jobs, []
                ops.extend(op for op, _, _ in jobs)
                record = {"iter": self._mh_iter, "ops": ops, "outcomes": self._mh_outcomes}
                self._mh_iter += 1
            if self._mh_publish is not None:
                self._mh_publish(record)
            # The jobs' collectives, before the step's: the followers run
            # them in the record's order, before their step.
            outcomes = []
            for _, run, fut in jobs:
                try:
                    fut.set_result(run())
                    outcomes.append("ok")
                except Exception as e:  # noqa: BLE001 — the caller raises it
                    fut.set_exception(e)
                    outcomes.append(type(e).__name__)
            self._mh_outcomes = outcomes
            return self._step_locked()


def follower_mode(core: EngineCore) -> None:
    """Mirror the leader's overload gating (``LeaderCore.__init__``): a
    follower must never expire or refuse what the leader admitted, nor
    release a hold the leader did not journal."""
    core.enforce_deadlines = False
    core._max_waiting = 0
    core.expire_holds = False
    core.mh_outcomes = []  # how its replay of the last record's jobs ended


# A follower's replay of each collective op. The leader's job raised the
# same KeyError or ValueError to its caller, at the same point, before any
# collective: the next record's ``outcomes`` says so, and a follower whose
# own differ has lost lockstep.
_REPLAY = {
    "read_held": lambda core, op: core.read_held_pages(op["rid"], op["start"], op["count"]),
    "read_cached": lambda core, op: core.read_cached_pages(op["hashes"]),
    "import": lambda core, op: core.import_blocks(op["blocks"]),
    "embed": lambda core, op: core.embed(op["tokens"]),
}


def apply_record(core: EngineCore, record: dict) -> None:
    """Apply one step record's ops to a follower's core (the step itself
    is the caller's): adds (a rejected one is rejected again, which keeps
    the request counter aligned), cancels, cache clears, releases of held
    blocks and the collective ops (:data:`_REPLAY`), in the record's
    order; the core is in :func:`follower_mode`. Raises when the leader's
    collective ops of the previous record ended otherwise than this
    rank's replay of them."""
    mine = core.mh_outcomes
    if record["outcomes"] != mine:
        raise RuntimeError(
            f"step record {record['iter'] - 1}: the leader's collective ops ended "
            f"{record['outcomes']}, this rank's {mine}: the follower lost lockstep"
        )
    outcomes = []
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
        elif kind == "release":
            core.release_held(op["rid"])
        else:
            try:
                _REPLAY[kind](core, op)
                outcomes.append("ok")
            except (KeyError, ValueError) as e:
                log.warning("step record %d: replaying %s raised %s: %s",
                            record["iter"], kind, type(e).__name__, e)
                outcomes.append(type(e).__name__)
    core.mh_outcomes = outcomes


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
        # Off the loop: the record's collective ops, then the step, run the
        # leader's collectives in the leader's order, each blocking until
        # every rank arrives.
        await asyncio.to_thread(_replay_step, core, record)


def _replay_step(core: EngineCore, record: dict) -> None:
    apply_record(core, record)
    core.step()

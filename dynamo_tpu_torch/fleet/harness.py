"""The fleet-scale harness.

The port's copy of ``dynamo_tpu/fleet/harness.py``, held to it by
``tests/test_torch_copies.py``.

Tens of mocker workers on one virtual clock, a synthetic multi-tenant
workload, the router's cost functions choosing placement
(``DefaultWorkerSelector``, ``NetworkAwareSelector``), the closed-loop
controller (``PlannerController``) scaling the pool, and chaos plans
killing or partitioning workers mid-run. Only the transport (HTTP, store,
data plane) is replaced by direct calls on the simulated timeline.

Each worker is a ``MockTpuEngine`` with its own local virtual clock;
fleet events (arrivals, controller ticks, chaos) are processed in global
time order. Scale-down is a graceful drain; a chaos ``kill`` stops
in-flight streams mid-token and migrates them, replayed on a survivor
with ``replay_base`` so the client-visible stream continues bit for bit.
Arrivals are generated once per seed, the selector runs at temperature 0
and the mocker's tokens depend only on stream position, so any two
scenarios that complete the same request emit the same bytes.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from dynamo_tpu_torch.fleet.workload import (
    Arrival,
    TenantSpec,
    generate_arrivals,
    tenant_hue,
)
from dynamo_tpu_torch.llm.disagg.target import choose_decode_target
from dynamo_tpu_torch.llm.kv_router.netcost import NetCostModel, NetworkAwareSelector
from dynamo_tpu_torch.llm.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.llm.kv_router.router import best_peer_hint
from dynamo_tpu_torch.llm.kv_router.scheduler import DefaultWorkerSelector
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequences
from dynamo_tpu_torch.llm.mocker.engine import MockEngineArgs, MockTpuEngine, _Seq
from dynamo_tpu_torch.llm.protocols.common import StopConditions
from dynamo_tpu_torch.planner.controller import ControllerConfig, PlannerController
from dynamo_tpu_torch.planner.perf_interpolation import from_profile
from dynamo_tpu_torch.planner.planner_core import (
    Observation,
    Planner,
    PlannerConfig,
    SlaTargets,
)
from dynamo_tpu_torch.tokens import TokenBlockSequence, compute_seq_hashes

# Wall-clock budget a failed (partitioned) pull burns before the breaker
# path gives up — the cost a stalled peer charges the puller's clock.
PULL_TIMEOUT_MS = 50.0
# Hard ceiling on post-workload drain, as a multiple of the duration — a
# wedged sim fails loudly instead of spinning forever.
MAX_OVERRUN = 4.0


def mocker_profile(
    base_iter_us: float,
    prefill_us_per_token: float,
    decode_us_per_seq: float,
    max_num_seqs: int,
) -> dict:
    """The mocker cost model swept into the planner's offline profile —
    the virtual-fleet equivalent of running ``benchmarks/profile_sla.py``
    against one replica. TTFT(isl) is one monolithic prefill iteration;
    ITL(conc) is one decode iteration at that batch (every lane emits a
    token per iteration, so seconds/iteration IS seconds/token)."""
    isl_grid = [32.0, 128.0, 512.0, 2048.0, 8192.0]
    conc_grid = [float(c) for c in range(1, max_num_seqs + 1)]
    return {
        "prefill": {
            "isl": isl_grid,
            "ttft_s": [
                (base_iter_us + isl * prefill_us_per_token) / 1e6
                for isl in isl_grid
            ],
        },
        "decode": {
            "concurrency": conc_grid,
            "itl_s": [
                (base_iter_us + c * decode_us_per_seq) / 1e6 for c in conc_grid
            ],
        },
    }


@dataclass(frozen=True)
class ChaosEvent:
    """A mid-run fault: ``kill`` stops a worker dead (in-flight streams
    migrate), ``partition`` makes every pull touching the worker fail for
    ``duration_s`` (placements degrade to local recompute), ``drain``
    forces a graceful scale-down of the worker at that instant (the
    chaos-tested kill-during-scale-down scenario composes drain + kill),
    and ``store_outage`` blacks out the control plane fleet-wide for
    ``duration_s`` (ISSUE 15): every store session severs at once, leases
    expire one TTL in, and what happens next depends on
    ``FleetSpec.discovery_stale_grace_s`` — degraded mode keeps routing
    on the cached instance snapshot (data-plane liveness), grace = 0
    replays the pre-ISSUE-15 collapse (lease-expiry deletes drop every
    instance and new requests shed)."""

    t: float
    action: str            # "kill" | "partition" | "drain" | "store_outage"
    worker: int = -1                 # worker id; -1 = newest draining worker
    duration_s: float = 0.0


@dataclass
class FleetSpec:
    tenants: list[TenantSpec]
    duration_s: float = 240.0
    seed: int = 0
    block_size: int = 8
    # One worker's cost model (tens of these make the fleet).
    max_num_seqs: int = 4
    num_kv_blocks: int = 2048
    max_waiting: int = 0             # bounded admission queue (0 = unbounded)
    base_iter_us: float = 20_000.0
    prefill_us_per_token: float = 100.0
    decode_us_per_seq: float = 5_000.0
    # Step scheduler ("chunked" | "waves"), passed to every worker's
    # mock engine. Waves is where disagg earns its keep: an aggregated
    # worker stalls every decode lane while a prompt prefills, a disagg
    # decode worker never prefills (its continuations arrive cached).
    scheduling: str = "chunked"
    # Routing.
    network_aware: bool = False
    overlap_weight: float = 1.0
    queue_weight: float = 1.0
    pull_enabled: bool = True
    pull_ms_per_block: float = 0.2   # default per-SOURCE transfer cost
    worker_pull_ms: dict[int, float] = field(default_factory=dict)
    # Per-worker iteration-cost multiplier (> 1 = slower hardware / hot
    # node): the heterogeneity NetKV's queue-depth term exists for.
    worker_speed: dict[int, float] = field(default_factory=dict)
    # Autoscaling. planner_on=False freezes the pool at static_replicas —
    # the equal-budget baseline the A/B compares against.
    planner_on: bool = True
    static_replicas: int = 4
    initial_replicas: int = 2
    min_replicas: int = 1
    max_replicas: int = 16
    # 2.5 s control interval: fast enough that a 10 s tenant burst gets
    # one reactive scale-up while it still matters; hysteresis (not the
    # interval) is what stops flapping.
    control_interval_s: float = 2.5
    controller: ControllerConfig | None = None
    sla: SlaTargets = field(default_factory=lambda: SlaTargets(ttft_s=0.35, itl_s=0.08))
    chaos: list[ChaosEvent] = field(default_factory=list)
    # Out-of-band load: worker id -> background requests/second injected
    # straight into that worker's admission queue, NOT routed through
    # the selector. Another frontend's traffic, in effect: invisible to
    # this router's ActiveSequences bookkeeping (no placement was ever
    # announced here) and visible only through the worker's own reported
    # queue/slot metrics — the exact signal NetKV's queue-depth term
    # exists to read.
    background_rps: dict[int, float] = field(default_factory=dict)
    background_isl: int = 32
    background_osl: int = 6
    # Control-plane model: worker registrations live under
    # leases of this TTL; a ``store_outage`` chaos event expires them one
    # TTL in and recovery re-registers every surviving worker within one
    # further TTL (deterministically staggered, the full-jitter twin).
    lease_ttl_s: float = 10.0
    # Degraded-mode knob (the sim twin of DYN_DISCOVERY_STALE_GRACE_S):
    # > 0 quarantines lease-expiry deletes while the data plane answers —
    # routing keeps the last-known-good snapshot through the blackout;
    # 0 honors every delete immediately (the collapse baseline).
    discovery_stale_grace_s: float = 30.0
    # Keep per-request token streams in the report (the bit-identity
    # audits want them; the big bench fleet turns them off to save RAM).
    keep_streams: bool = True
    # Disaggregated topology: split the fleet into a prefill
    # pool and a decode pool. Arrivals whose prompt exceeds
    # ``max_local_prefill_tokens`` run their prefill on a prefill-pool
    # worker (max_tokens=1 — TTFT comes from that worker), then the KV
    # hands off to a COST-CHOSEN decode worker (the production
    # ``choose_decode_target``) where the stream continues by token
    # replay, bit-identically. ``streaming_handoff`` prices the
    # chunk-pipelined transfer: all but the final ``disagg_chunk_blocks``
    # window moved while prefill was still chunking, so only the tail
    # charge lands on the decode clock; False replays the legacy
    # pull-after-prefill (every block billed after prefill completes).
    # The planner sees the pools separately ({"prefill", "decode"}
    # components) and shifts the ratio live.
    disagg: bool = False
    max_local_prefill_tokens: int = 32
    disagg_chunk_blocks: int = 16
    streaming_handoff: bool = True
    # Initial/static prefill share of the pool (each pool keeps >= 1).
    prefill_fraction: float = 0.34


@dataclass
class _Rec:
    """One request's client-side ledger across its whole life (including
    migration hops)."""

    arrival: Arrival
    t_first: float | None = None     # fleet time of first streamed token
    t_last: float | None = None
    tokens: list[int] = field(default_factory=list)
    n_tokens: int = 0
    shed: str | None = None          # typed shed reason, None = served
    finishes: int = 0
    workers: list[int] = field(default_factory=list)
    done: bool = False


class SimWorker:
    def __init__(
        self, wid: int, spec: FleetSpec, t0: float, role: str = "backend"
    ):
        self.id = wid
        self.spec = spec
        self.role = role                       # "backend" | "prefill" | "decode"
        self.vt = t0                           # local virtual clock
        self.draining = False
        self.dead = False
        self.pull_ms_per_block = spec.worker_pull_ms.get(
            wid, spec.pull_ms_per_block
        )
        self.speed = spec.worker_speed.get(wid, 1.0)
        self.eng = MockTpuEngine(
            MockEngineArgs(
                num_kv_blocks=spec.num_kv_blocks,
                block_size=spec.block_size,
                max_num_seqs=spec.max_num_seqs,
                max_num_batched_tokens=4096,
                max_waiting=spec.max_waiting,
                base_iter_us=spec.base_iter_us,
                prefill_us_per_token=spec.prefill_us_per_token,
                decode_us_per_seq=spec.decode_us_per_seq,
                scheduling=spec.scheduling,
                kv_pull_us_per_block=0.0,      # pulls priced per-source here
            )
        )
        # Deadline expiry judged on the worker's virtual clock.
        self.eng.clock = lambda: self.vt
        # Sequences routed here whose out queues the harness still
        # drains — a finished seq leaves eng._running inside _step, so
        # the harness must keep its own handle to collect final frames.
        self.inflight: list[_Seq] = []

    @property
    def busy(self) -> bool:
        return bool(self.eng._waiting or self.eng._running)

    def step(self) -> None:
        a = self.eng.args
        self.eng._admit()
        p, d = self.eng._step()
        self.vt += self.speed * (
            a.base_iter_us
            + p * a.prefill_us_per_token
            + d * a.decode_us_per_seq
        ) / 1e6


class SimConnector:
    """The harness's Connector: ``set_replicas`` spawns instantly and
    scales down by marking the least-loaded workers draining — the
    in-sim twin of LocalProcessConnector's spawn / SIGTERM-drain, on the
    virtual clock. Never kills."""

    def __init__(self, harness: "FleetHarness"):
        self.harness = harness
        self.calls: list[tuple[float, str, int]] = []
        self.scale_ups = 0
        self.scale_downs = 0

    async def set_replicas(self, component: str, replicas: int) -> None:
        h = self.harness
        self.calls.append((h.t, component, replicas))
        role = component if h.spec.disagg else "backend"
        live = [
            w
            for w in h.workers
            if not w.dead and not w.draining and w.role == role
        ]
        if replicas > len(live):
            for _ in range(replicas - len(live)):
                h.spawn_worker(role=role)
            self.scale_ups += 1
        elif replicas < len(live):
            # Victim choice mirrors an orchestrator draining the
            # emptiest pods first; ties break to the newest worker so
            # long-warmed prefix caches survive.
            load = {
                w.id: len(w.eng._running) + len(w.eng._waiting) for w in live
            }
            victims = sorted(live, key=lambda w: (load[w.id], -w.id))
            for w in victims[: len(live) - replicas]:
                w.draining = True
            self.scale_downs += 1

    def current(self, component: str) -> int:
        role = component if self.harness.spec.disagg else "backend"
        return sum(
            1
            for w in self.harness.workers
            if not w.dead and not w.draining and w.role == role
        )


@dataclass
class FleetReport:
    scenario: str
    duration_s: float
    requests: int
    completed: int
    shed: int
    broken_streams: int
    attainment_ttft: float
    attainment_tpot: float
    goodput_tok_s: float
    ttft_p50_ms: float
    ttft_p99_ms: float
    tpot_p50_ms: float
    replica_seconds: float
    mean_replicas: float
    peak_replicas: int
    decisions: dict
    scale_ups: int
    scale_downs: int
    drained_retired: int
    migrations: int
    placements: dict[int, int]
    pulls_by_source: dict[int, int]
    failed_pulls: int
    streams: dict[str, list[int]] | None
    # Control-plane blackout audit (all zero without a
    # store_outage event).
    model_flaps: int = 0             # discovery add/remove transitions
    blackout_routed: int = 0         # NEW requests placed mid-blackout
    blackout_shed: int = 0           # NEW requests shed mid-blackout
    reregister_lag_s: float = 0.0    # slowest post-recovery re-register
    kv_resyncs: int = 0              # inventory resyncs on session replay
    # Disagg audit (all zero on an aggregated fleet).
    e2e_p50_ms: float = 0.0          # arrival -> last token, completions
    remote_prefills: int = 0         # requests whose prefill ran remote
    handoffs_streamed: int = 0       # KV handoffs that landed via import
    handoff_fallbacks: int = 0       # handoffs degraded to local recompute
    handoff_blocks: int = 0          # blocks moved prefill -> decode

    def summary(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "streams"}
        d["placements"] = dict(sorted(self.placements.items()))
        d["pulls_by_source"] = dict(sorted(self.pulls_by_source.items()))
        return d


class FleetHarness:
    def __init__(self, spec: FleetSpec):
        self.spec = spec
        self.t = 0.0
        self.workers: list[SimWorker] = []
        self._next_wid = 0
        self.retired_drained = 0
        self.migrations = 0
        self.failed_pulls = 0
        # Disagg handoff ledger: rid -> pending handoff info
        # while the remote prefill runs; _handed_off marks prefill legs
        # whose continuation already landed on a decode worker.
        self._handoffs: dict[str, dict] = {}
        self._handed_off: set[str] = set()
        # Continuations in flight to a decode worker: wid -> [(ready_t,
        # seq)]. Delivered when the TARGET's own clock reaches ready_t —
        # never by jumping its clock, which would steal virtual time
        # from co-resident decode lanes.
        self._pending_cont: dict[int, list[tuple[float, _Seq]]] = {}
        self.remote_prefills = 0
        self.handoffs_streamed = 0
        self.handoff_fallbacks = 0
        self.handoff_blocks = 0
        self.placements: dict[int, int] = {}
        self.pulls_by_source: dict[int, int] = {}
        self.recs: dict[str, _Rec] = {}
        self._partitioned: dict[int, float] = {}   # worker id -> until t
        # Control-plane blackout state.
        self._outage_start: float | None = None
        self._outage_end: float = 0.0
        self._outage_workers: set[int] = set()   # leased when it began
        self._resynced: set[int] = set()
        self._model_present = True
        self.model_flaps = 0
        self.blackout_routed = 0
        self.blackout_shed = 0
        self._replica_seconds = 0.0
        self._peak = 0
        self._last_acct_t = 0.0
        self.active = ActiveSequences(block_size=spec.block_size)
        self.rconfig = RouterConfig(
            overlap_weight=spec.overlap_weight,
            temperature=0.0,
            network_aware=spec.network_aware,
            queue_weight=spec.queue_weight,
            block_size=spec.block_size,
        )
        # Recompute yardstick: what one block of local prefill costs on
        # this fleet's priced cost model.
        self.netcost = NetCostModel(
            recompute_ms_per_block=(
                spec.block_size * spec.prefill_us_per_token / 1e3
            ),
            fleet_view=self._fleet_view,
            cache_s=0.0,
            clock=lambda: self.t,
        )
        if spec.network_aware:
            self.selector: DefaultWorkerSelector = NetworkAwareSelector(
                self.netcost
            )
        else:
            self.selector = DefaultWorkerSelector()
        # The closed loop: mocker cost model swept into the profile the
        # planner interpolates, controller clocked on fleet time.
        prefill_i, decode_i = from_profile(
            mocker_profile(
                spec.base_iter_us,
                spec.prefill_us_per_token,
                spec.decode_us_per_seq,
                spec.max_num_seqs,
            )
        )
        self.connector = SimConnector(self)
        self.planner = Planner(
            prefill_i,
            decode_i,
            self.connector,
            sla=spec.sla,
            config=PlannerConfig(
                adjustment_interval_s=spec.control_interval_s,
                min_replicas=spec.min_replicas,
                max_replicas=spec.max_replicas,
                predictor="ar",
                # Plan with ramp headroom: the diurnal slope moves faster
                # than one control interval, and capacity arriving a tick
                # late is a queue already formed.
                utilization_target=0.8,
            ),
        )
        self.controller = PlannerController(
            self.planner,
            self.connector,
            # Aggregated fleet: one pool sized to the max requirement.
            # Disagg fleet: the planner's native split — prefill and
            # decode scale independently, so the ratio shifts live.
            pools=(
                {"prefill": "prefill", "decode": "decode"}
                if spec.disagg
                else {"backend": "max"}
            ),
            config=spec.controller
            or ControllerConfig(
                interval_s=spec.control_interval_s,
                scale_up_cooldown_s=spec.control_interval_s,
                scale_down_cooldown_s=2 * spec.control_interval_s,
                down_stable_cycles=2,
                max_step_up=4,
                max_step_down=1,
                queue_depth_per_replica=8.0,
                min_replicas=spec.min_replicas,
                max_replicas=spec.max_replicas,
            ),
            clock=lambda: self.t,
        )
        start = spec.initial_replicas if spec.planner_on else spec.static_replicas
        if spec.disagg:
            starts = self._pool_split(start)
            for comp, pool in self.controller.pools.items():
                pool.target = pool.desired = starts[comp]
            for comp in ("prefill", "decode"):
                for _ in range(starts[comp]):
                    self.spawn_worker(role=comp)
        else:
            for pool in self.controller.pools.values():
                pool.target = pool.desired = start
            for _ in range(start):
                self.spawn_worker()
        # Per-window stats the controller tick turns into an Observation.
        self._win = self._fresh_window()

    # -- fleet plumbing ----------------------------------------------------

    def _pool_split(self, total: int) -> dict[str, int]:
        """Split ``total`` replicas into disagg pools: the prefill pool
        gets ``prefill_fraction`` of the budget, both pools keep >= 1."""
        total = max(2, total)
        p = max(1, min(total - 1, round(total * self.spec.prefill_fraction)))
        return {"prefill": p, "decode": total - p}

    def spawn_worker(self, role: str = "backend") -> SimWorker:
        w = SimWorker(self._next_wid, self.spec, self.t, role=role)
        self._next_wid += 1
        self.workers.append(w)
        self.placements.setdefault(w.id, 0)
        return w

    def _live(self, routable: bool = False) -> list[SimWorker]:
        return [
            w
            for w in self.workers
            if not w.dead and not (routable and w.draining)
        ]

    def _fleet_view(self) -> dict:
        """The WorkerMonitor twin: live workers' ForwardPassMetrics —
        queue depths + each worker's measured per-peer pull costs — the
        NetCostModel folds exactly as it would from the real monitor."""
        out = {}
        for w in self._live():
            m = w.eng.metrics()
            m.worker_id = w.id
            out[w.id] = m
        return out

    # -- control-plane blackout model ---------------------------

    def _rereg_delay(self, wid: int) -> float:
        """Deterministic post-recovery re-register stagger in
        (0, lease_ttl_s) — the sim twin of the client's full-jitter
        redial + session replay, always within one TTL."""
        return self.spec.lease_ttl_s * (
            0.15 + 0.8 * ((wid * 2654435761 % 97) / 97.0)
        )

    @property
    def _store_dark(self) -> bool:
        return (
            self._outage_start is not None
            and self._outage_start <= self.t < self._outage_end
        )

    def _discovered(self, w: SimWorker, t: float) -> bool:
        """The router's discovery view of one worker: the twin of
        EndpointClient under a store blackout. Before lease expiry the
        cached entry is simply current; after it, degraded mode
        quarantines the lease-expiry delete while the worker's data
        plane answers (``not w.dead`` here — the sim's probe), while
        grace = 0 honors the delete and the worker only reappears when
        its client's session replay re-registers it after recovery."""
        if self._outage_start is None or w.id not in self._outage_workers:
            return True
        expiry = self._outage_start + self.spec.lease_ttl_s
        if t < expiry:
            return True
        if self.spec.discovery_stale_grace_s > 0:
            return not w.dead
        return not w.dead and t >= self._outage_end + self._rereg_delay(w.id)

    def _track_control_plane(self, t: float) -> None:
        """Advance the discovery timeline to ``t``: count model
        add/remove flaps (the ModelWatcher twin) and, after recovery,
        session-replay inventory resyncs as each worker re-registers."""
        if self._outage_start is None:
            return
        live = [w for w in self.workers if not w.dead]
        present = any(self._discovered(w, t) for w in live) if live else False
        if present != self._model_present:
            self.model_flaps += 1
            self._model_present = present
        if t >= self._outage_end:
            for w in live:
                if (
                    w.id in self._outage_workers
                    and w.id not in self._resynced
                    and t >= self._outage_end + self._rereg_delay(w.id)
                ):
                    # The client's reconnect replay re-puts the lease-bound
                    # registration AND triggers the KV-event anti-entropy
                    # resync (publisher re-inventories to the fresh store).
                    self._resynced.add(w.id)

    def _fresh_window(self) -> dict:
        return {
            "arrivals": 0,
            "isl_sum": 0.0,
            "osl_sum": 0.0,
            "ttft": [],
            "tpot": [],
            "sheds": 0,
        }

    def _account(self, until: float) -> None:
        """Integrate replica-seconds (draining workers still bill — their
        capacity is not yet released) up to fleet time ``until``."""
        n = len(self._live())
        self._peak = max(self._peak, n)
        self._replica_seconds += n * max(0.0, until - self._last_acct_t)
        self._last_acct_t = until

    # -- routing -----------------------------------------------------------

    def _route(
        self,
        arr: Arrival,
        *,
        replay_base: int = 0,
        max_tokens: int | None = None,
        exclude: set[int] | None = None,
        deadline: bool = True,
    ) -> None:
        # Disagg: a fresh long-prompt arrival runs its prefill on the
        # prefill pool, then hands off (the streaming-handoff contract).
        # Replays (migration, handoff fallback) and short prompts decode
        # locally in the decode pool — and if the prefill pool is gone,
        # the remote route degrades to exactly that local path.
        if (
            self.spec.disagg
            and replay_base == 0
            and exclude is None
            and len(arr.token_ids) > self.spec.max_local_prefill_tokens
            and self._route_remote_prefill(arr, deadline=deadline)
        ):
            return
        cands = [
            w
            for w in self._live(routable=True)
            if (not exclude or w.id not in exclude)
            and self._discovered(w, self.t)
            and (not self.spec.disagg or w.role == "decode")
        ]
        in_blackout = self._store_dark and replay_base == 0
        if not cands:
            # Whole fleet draining/dead/undiscovered: nothing routable.
            # Count as a typed shed (the frontend would return a
            # retryable 503).
            rec = self.recs[arr.rid]
            rec.shed = "no_workers"
            rec.done = True
            self._win["sheds"] += 1
            if in_blackout:
                self.blackout_shed += 1
            return
        if in_blackout:
            self.blackout_routed += 1
        by_id = {w.id: w for w in cands}
        prompt = arr.token_ids
        hashes = compute_seq_hashes(prompt, self.spec.block_size)
        overlaps = {w.id: w.eng.kv.match_prefix(hashes) for w in cands}
        sel = self.selector.select_worker(
            list(by_id), overlaps, len(prompt), self.active, self.rconfig
        )
        w = by_id[sel.worker_id]
        w.vt = max(w.vt, self.t)
        self.placements[w.id] = self.placements.get(w.id, 0) + 1
        # Peer-prefix pull, cost-decided in network-aware mode and
        # most-blocks in overlap-only mode (the router.peer_hint split).
        if self.spec.pull_enabled:
            hint = self._peer_hint(sel, overlaps)
            if hint is not None:
                self._pull(w, hint[0], hashes[: hint[1]])
        seq = _Seq(
            request_id=arr.rid,
            prompt=list(prompt),
            max_tokens=max_tokens if max_tokens is not None else arr.osl,
            out=asyncio.Queue(),
            seq=TokenBlockSequence(list(prompt), self.spec.block_size),
            prompt_hashes=hashes,
            stop=StopConditions(
                max_tokens=max_tokens if max_tokens is not None else arr.osl,
                ignore_eos=True,
            ),
            tenant_id=arr.tenant,
            replay_base=replay_base,
        )
        if deadline and arr.deadline_ms is not None:
            seq.deadline_epoch = arr.t + arr.deadline_ms / 1e3
        w.eng._waiting.append(seq)
        w.inflight.append(seq)
        self.active.add_request(
            arr.rid, w.id, len(prompt), sel.overlap_blocks
        )
        self.recs[arr.rid].workers.append(w.id)

    def _peer_hint(self, sel, overlaps: dict[int, int]) -> tuple[int, int] | None:
        if self.spec.network_aware:
            return sel.pull_hint
        if not overlaps:
            return None
        peer, blocks = best_peer_hint(overlaps)
        if peer != sel.worker_id and blocks > sel.overlap_blocks:
            return peer, blocks
        return None

    def _pull(self, w: SimWorker, source: int, hashes: list[int]) -> None:
        """Move a peer's cached prefix onto ``w`` at the SOURCE's priced
        per-block cost; failures (partition, dead source) charge the
        timeout budget and fall back to local recompute — the PR 6
        degrade-never-stall contract."""
        src = next((x for x in self.workers if x.id == source), None)
        cut = self._partitioned
        blocked = (
            src is None
            or src.dead
            or cut.get(source, 0.0) > self.t
            or cut.get(w.id, 0.0) > self.t
        )
        if blocked:
            self.failed_pulls += 1
            w.vt += PULL_TIMEOUT_MS / 1e3
            w.eng.peer_stats.note_pull(source, 0, PULL_TIMEOUT_MS, False)
            return
        parents = [hashes[i - 1] if i else None for i in range(len(hashes))]
        imported, _ = w.eng.import_peer_blocks(hashes, parents)
        if not imported:
            return
        cost_ms = imported * src.pull_ms_per_block
        w.vt += cost_ms / 1e3
        w.eng.peer_stats.note_pull(source, imported, cost_ms, True)
        self.pulls_by_source[source] = (
            self.pulls_by_source.get(source, 0) + imported
        )

    # -- disaggregated topology ---------------------------------

    def _route_remote_prefill(self, arr: Arrival, *, deadline: bool) -> bool:
        """Place the prefill leg (max_tokens=1) on the least-loaded
        prefill-pool worker; the first token — TTFT — streams from there.
        Returns False when no prefill worker is routable, and the caller
        degrades to a local decode-pool route."""
        cands = [
            w
            for w in self._live(routable=True)
            if w.role == "prefill" and self._discovered(w, self.t)
        ]
        if not cands:
            return False
        if self._store_dark:
            self.blackout_routed += 1
        w = min(
            cands,
            key=lambda x: (len(x.eng._waiting) + len(x.eng._running), x.id),
        )
        w.vt = max(w.vt, self.t)
        self.placements[w.id] = self.placements.get(w.id, 0) + 1
        prompt = arr.token_ids
        hashes = compute_seq_hashes(prompt, self.spec.block_size)
        seq = _Seq(
            request_id=arr.rid,
            prompt=list(prompt),
            max_tokens=1,
            out=asyncio.Queue(),
            seq=TokenBlockSequence(list(prompt), self.spec.block_size),
            prompt_hashes=hashes,
            stop=StopConditions(max_tokens=1, ignore_eos=True),
            tenant_id=arr.tenant,
        )
        if deadline and arr.deadline_ms is not None:
            seq.deadline_epoch = arr.t + arr.deadline_ms / 1e3
        w.eng._waiting.append(seq)
        w.inflight.append(seq)
        self.active.add_request(arr.rid, w.id, len(prompt), 0)
        self.recs[arr.rid].workers.append(w.id)
        self.remote_prefills += 1
        self._handoffs[arr.rid] = {"src": w.id, "hashes": hashes}
        return True

    def _complete_handoff(self, src: SimWorker, rec: _Rec, hand: dict) -> None:
        """Prefill finished on ``src``: pick the decode target with the
        production chooser, price the KV handoff onto its clock, and
        continue the stream there by token replay. A sever (partition or
        dead source) at the handoff boundary degrades to local recompute
        on the decode worker — bit-identical, since the token function
        depends only on stream position (the mocker's stand-in for the
        deterministic recompute of the same prompt)."""
        spec = self.spec
        arr = rec.arrival
        remaining = arr.osl - rec.n_tokens
        if remaining <= 0:
            return
        cands = [
            w
            for w in self._live(routable=True)
            if w.role == "decode" and self._discovered(w, self.t)
        ]
        self._handed_off.add(arr.rid)
        if not cands:
            rec.shed = "no_workers"
            rec.done = True
            self._win["sheds"] += 1
            self.active.free(arr.rid)
            return
        by_id = {w.id: w for w in cands}
        hashes = hand["hashes"]
        tid = choose_decode_target(
            sorted(by_id),
            len(hashes),
            lambda wid: src.pull_ms_per_block,
            lambda wid: float(
                len(by_id[wid].eng._waiting)
                + len(by_id[wid].eng._running)
                + len(self._pending_cont.get(wid, []))
            ),
        )
        w = by_id[tid]
        self.placements[w.id] = self.placements.get(w.id, 0) + 1
        # The handoff departs when prefill finished, on the SOURCE clock;
        # only the transfer tail separates that from decode start — the
        # wire does the work, so the tail delays THIS continuation
        # without charging the target's compute clock.
        departed = max(src.vt, self.t)
        cut = self._partitioned
        blocked = (
            src.dead
            or cut.get(src.id, 0.0) > self.t
            or cut.get(w.id, 0.0) > self.t
        )
        if blocked:
            # Sever mid-handoff: burn the timeout budget, skip the
            # import — local recompute serves the continuation.
            self.failed_pulls += 1
            self.handoff_fallbacks += 1
            ready = departed + PULL_TIMEOUT_MS / 1e3
            w.eng.peer_stats.note_pull(src.id, 0, PULL_TIMEOUT_MS, False)
        else:
            parents = [
                hashes[i - 1] if i else None for i in range(len(hashes))
            ]
            # imported counts only blocks the target didn't already hold
            # (a hot shared prefix may be cached there) — a zero-block
            # handoff is still a streamed handoff, just free.
            imported, _ = w.eng.import_peer_blocks(hashes, parents)
            cost_ms = 0.0
            if imported:
                # Streaming handoff: every window but the last moved
                # while prefill was still chunking, so only the tail
                # remains in flight at prefill completion; the legacy
                # pull serializes every block behind prefill.
                charged = (
                    min(imported, spec.disagg_chunk_blocks)
                    if spec.streaming_handoff
                    else imported
                )
                cost_ms = charged * src.pull_ms_per_block
                w.eng.peer_stats.note_pull(src.id, imported, cost_ms, True)
                self.pulls_by_source[src.id] = (
                    self.pulls_by_source.get(src.id, 0) + imported
                )
            ready = departed + cost_ms / 1e3
            self.handoffs_streamed += 1
            self.handoff_blocks += imported
        prompt = arr.token_ids
        seq = _Seq(
            request_id=arr.rid,
            prompt=list(prompt),
            max_tokens=remaining,
            out=asyncio.Queue(),
            seq=TokenBlockSequence(list(prompt), spec.block_size),
            prompt_hashes=hashes,
            stop=StopConditions(max_tokens=remaining, ignore_eos=True),
            tenant_id=arr.tenant,
            # Token replay from the committed position (the migration
            # contract): the continuation stream stays byte-identical.
            replay_base=rec.n_tokens,
        )
        self._pending_cont.setdefault(w.id, []).append((ready, seq))
        self.active.free(arr.rid)
        self.active.add_request(arr.rid, w.id, len(prompt), len(hashes))
        rec.workers.append(w.id)

    def _ready_pending(self, w: SimWorker, limit: float) -> None:
        """Admit queued continuations whose handoff tail has landed by
        worker-clock ``limit``."""
        q = self._pending_cont.get(w.id)
        if not q:
            return
        rest = [item for item in q if item[0] > limit]
        for ready, seq in q:
            if ready <= limit:
                w.eng._waiting.append(seq)
                w.inflight.append(seq)
        if rest:
            self._pending_cont[w.id] = rest
        else:
            self._pending_cont.pop(w.id, None)

    def _next_pending(self, w: SimWorker) -> float | None:
        q = self._pending_cont.get(w.id)
        return min(r for r, _ in q) if q else None

    # -- stream collection -------------------------------------------------

    def _drain_frames(self, w: SimWorker) -> None:
        done: list[_Seq] = []
        for seq in w.inflight:
            self._drain_seq(w, seq)
            rec = self.recs.get(seq.request_id)
            if rec is None:
                continue
            retired = rec.done
            # A handed-off prefill leg is finished from THIS worker's
            # perspective even though the request lives on: the
            # continuation is someone else's inflight entry.
            if (
                not retired
                and seq.request_id in self._handed_off
                and seq.replay_base == 0
                and seq.generated >= seq.max_tokens
            ):
                retired = True
            if retired and seq.out.empty():
                done.append(seq)
        for seq in done:
            w.inflight.remove(seq)

    def _drain_seq(self, w: SimWorker, seq: _Seq) -> None:
        rec = self.recs.get(seq.request_id)
        if rec is None:
            return
        while not seq.out.empty():
            item = seq.out.get_nowait()
            if not isinstance(item, dict):
                continue
            toks = item.get("token_ids") or []
            if toks and rec.t_first is None:
                rec.t_first = w.vt
            if toks:
                rec.t_last = w.vt
                rec.n_tokens += len(toks)
                if self.spec.keep_streams:
                    rec.tokens.extend(toks)
            fin = item.get("finish_reason")
            if fin:
                rec.finishes += 1
                if fin == "error":
                    rec.shed = (item.get("meta") or {}).get("shed", "error")
                    self._win["sheds"] += 1
                    rec.done = True
                    self.active.free(rec.arrival.rid)
                    self._handoffs.pop(seq.request_id, None)
                elif rec.n_tokens >= self._budget(rec):
                    rec.done = True
                    self.active.free(rec.arrival.rid)
                    self._finish_stats(rec)
                    self._handoffs.pop(seq.request_id, None)
                else:
                    # Disagg: the prefill leg closed with the stream
                    # still short of its budget — the handoff fires now,
                    # on the source worker's clock.
                    hand = self._handoffs.pop(seq.request_id, None)
                    if hand is not None:
                        self._complete_handoff(w, rec, hand)

    def _budget(self, rec: _Rec) -> int:
        return rec.arrival.osl

    def _finish_stats(self, rec: _Rec) -> None:
        arr = rec.arrival
        if rec.t_first is None:
            return
        ttft = rec.t_first - arr.t
        self._win["ttft"].append(ttft)
        if arr.osl > 1 and rec.t_last is not None and rec.t_last > rec.t_first:
            self._win["tpot"].append(
                (rec.t_last - rec.t_first) / (arr.osl - 1)
            )

    # -- engine advance ----------------------------------------------------

    def _advance(self, until: float) -> None:
        for w in list(self.workers):
            if w.dead:
                continue
            while w.vt < until:
                self._ready_pending(w, w.vt)
                if w.busy:
                    w.step()
                    self._drain_frames(w)
                    continue
                # Idle: jump straight to the next continuation landing
                # (if any lands inside this window).
                nxt = self._next_pending(w)
                if nxt is None or nxt > until:
                    break
                w.vt = max(w.vt, nxt)
            if not w.busy:
                w.vt = max(w.vt, until)
                self._ready_pending(w, w.vt)
                if w.draining and not w.busy and w.id not in self._pending_cont:
                    # Graceful drain complete: everything the worker
                    # accepted has streamed; now it retires.
                    w.dead = True
                    self.retired_drained += 1
                    self.active.remove_worker(w.id)

    # -- control loop ------------------------------------------------------

    def _tick(self, loop: asyncio.AbstractEventLoop) -> None:
        win, spec = self._win, self.spec
        window = spec.control_interval_s
        n = win["arrivals"]
        ttfts, tpots = win["ttft"], win["tpot"]
        att: dict[str, float] = {}
        if ttfts:
            att["ttft"] = sum(
                1 for v in ttfts if v <= spec.sla.ttft_s
            ) / len(ttfts)
        if tpots:
            att["tpot"] = sum(
                1 for v in tpots if v <= spec.sla.itl_s
            ) / len(tpots)
        live = self._live(routable=True)
        # observed_ttft_s is deliberately NOT fed: the harness's client
        # TTFT includes queue wait, and the prefill correction factor
        # must never be driven by queueing (planner_core's own rule —
        # it prefers the tracer's prefill-phase mean for this reason).
        # Queue pressure reaches the controller through queue_depth /
        # sheds / slo_attainment instead.
        obs = Observation(
            request_rate=n / window,
            mean_isl=(win["isl_sum"] / n) if n else 128.0,
            mean_osl=(win["osl_sum"] / n) if n else 16.0,
            observed_itl_s=(sum(tpots) / len(tpots)) if tpots else None,
            queue_depth=float(
                sum(len(w.eng._waiting) for w in self._live())
            ),
            shed_delta=float(win["sheds"]),
            slo_attainment=att or None,
            live_workers=(
                {
                    "prefill": sum(1 for w in live if w.role == "prefill"),
                    "decode": sum(1 for w in live if w.role == "decode"),
                }
                if spec.disagg
                else {"backend": len(live)}
            ),
            # Store blackout: the event-plane feed is dark, so
            # the REAL controller's degraded_hold path freezes actuation —
            # the harness drives the same production code the fleet runs.
            control_plane_degraded=self._store_dark,
        )
        loop.run_until_complete(self.controller.cycle(obs))
        self._win = self._fresh_window()

    def _chaos(self, ev: ChaosEvent) -> None:
        if ev.action == "store_outage":
            self._outage_start = self.t
            self._outage_end = self.t + ev.duration_s
            self._outage_workers = {w.id for w in self.workers if not w.dead}
            self._resynced.clear()
            return
        if ev.action == "partition":
            wid = ev.worker
            self._partitioned[wid] = max(
                self._partitioned.get(wid, 0.0), self.t + ev.duration_s
            )
            return
        if ev.action == "drain":
            w = next(
                (x for x in self.workers if x.id == ev.worker and not x.dead),
                None,
            )
            if w is not None:
                w.draining = True
            return
        if ev.action != "kill":
            raise ValueError(f"unknown chaos action {ev.action!r}")
        victim: SimWorker | None = None
        if ev.worker >= 0:
            victim = next(
                (w for w in self.workers if w.id == ev.worker and not w.dead),
                None,
            )
        else:
            draining = [w for w in self.workers if w.draining and not w.dead]
            victim = draining[-1] if draining else None
        if victim is None:
            return
        self._kill(victim)

    def _kill(self, w: SimWorker) -> None:
        """Chaos kill: the worker stops mid-decode. Frames already in the
        out queues were committed (the client received them) — keep them;
        everything unfinished migrates with ``replay_base`` at the
        committed position, continuing each stream bit-identically on a
        survivor (the PR 6 migration replay, on the sim timeline)."""
        w.dead = True
        w.eng._dead = True
        victims = list(w.inflight)
        # Continuations still in flight to this worker die with it too —
        # they re-route through the same migration replay below.
        victims += [seq for _, seq in self._pending_cont.pop(w.id, [])]
        for seq in victims:
            self._drain_seq(w, seq)
        w.inflight.clear()
        self.active.remove_worker(w.id)
        for seq in victims:
            rec = self.recs.get(seq.request_id)
            if rec is None or rec.done:
                continue
            if (
                seq.request_id in self._handed_off
                and seq.replay_base == 0
                and seq.generated >= seq.max_tokens
            ):
                # A retired prefill leg: the continuation already lives
                # on a decode worker — nothing here to migrate.
                continue
            # A prefill leg killed mid-prompt never hands off; the
            # migration replay below recomputes it on a survivor.
            self._handoffs.pop(seq.request_id, None)
            remaining = rec.arrival.osl - rec.n_tokens
            if remaining <= 0:
                continue
            self.migrations += 1
            # No deadline on the replay: migration is a completion
            # promise — tokens already streamed must never be followed
            # by a shed (the bit-identical replay contract).
            self._route(
                rec.arrival,
                replay_base=rec.n_tokens,
                max_tokens=remaining,
                exclude={w.id},
                deadline=False,
            )

    # -- run ---------------------------------------------------------------

    def _background_events(self) -> list[tuple[float, int]]:
        """(t, worker_id) grid of out-of-band arrivals, deterministic."""
        spec = self.spec
        out: list[tuple[float, int]] = []
        for wid, rps in spec.background_rps.items():
            if rps <= 0:
                continue
            step = 1.0 / rps
            t = step / 2.0
            while t < spec.duration_s:
                out.append((t, wid))
                t += step
        return out

    def _inject_background(self, wid: int, n: int) -> None:
        """One out-of-band request straight into the worker's admission
        queue — another frontend's traffic, bypassing this router."""
        spec = self.spec
        w = next(
            (x for x in self.workers if x.id == wid and not x.dead), None
        )
        if w is None:
            return
        prompt = [251 - (wid % 4)] * max(
            spec.block_size, spec.background_isl
        )
        seq = _Seq(
            request_id=f"bg-{wid}-{n}",
            prompt=prompt,
            max_tokens=spec.background_osl,
            out=asyncio.Queue(),
            seq=TokenBlockSequence(prompt, spec.block_size),
            prompt_hashes=compute_seq_hashes(prompt, spec.block_size),
            stop=StopConditions(
                max_tokens=spec.background_osl, ignore_eos=True
            ),
            tenant_id="background",
        )
        w.eng._waiting.append(seq)

    def run(self) -> FleetReport:
        spec = self.spec
        arrivals = generate_arrivals(
            spec.tenants, spec.duration_s, seed=spec.seed,
            block_size=spec.block_size,
        )
        for a in arrivals:
            self.recs[a.rid] = _Rec(arrival=a)
        # Fleet events in time order: arrivals first at a tie (the
        # controller observes a window that includes them), chaos next,
        # controller ticks last.
        events: list[tuple[float, int, object]] = [
            (a.t, 0, a) for a in arrivals
        ]
        events += [
            (tb, 0, ("bg", wid, i))
            for i, (tb, wid) in enumerate(self._background_events())
        ]
        events += [(c.t, 1, c) for c in spec.chaos]
        if spec.planner_on:
            n_ticks = int(spec.duration_s / spec.control_interval_s)
            events += [
                (i * spec.control_interval_s, 2, "tick")
                for i in range(1, n_ticks + 1)
            ]
        # Stable sort on (t, kind) only — payloads don't order, and ties
        # (same-instant arrivals, drain+kill chaos pairs) keep insertion
        # order.
        events.sort(key=lambda e: (e[0], e[1]))
        loop = asyncio.new_event_loop()
        try:
            for te, _, ev in events:
                self._advance(te)
                self._account(te)
                self.t = te
                self._track_control_plane(te)
                if isinstance(ev, Arrival):
                    self._win["arrivals"] += 1
                    self._win["isl_sum"] += len(ev.token_ids)
                    self._win["osl_sum"] += ev.osl
                    self._route(ev)
                elif isinstance(ev, ChaosEvent):
                    self._chaos(ev)
                elif isinstance(ev, tuple) and ev[0] == "bg":
                    self._inject_background(ev[1], ev[2])
                else:
                    self._tick(loop)
            # Drain the tail: advance everyone until nothing is in
            # flight (bounded — a wedged fleet fails loudly).
            deadline = spec.duration_s * (1.0 + MAX_OVERRUN)
            while any(w.busy for w in self._live()) or self._pending_cont:
                horizon = (
                    max(
                        [w.vt for w in self._live() if w.busy]
                        + [
                            r
                            for q in self._pending_cont.values()
                            for r, _ in q
                        ]
                    )
                    + 1.0
                )
                if horizon > deadline:
                    raise RuntimeError(
                        "fleet failed to drain: "
                        f"{sum(w.busy for w in self._live())} workers busy "
                        f"past t={deadline:.0f}s"
                    )
                self._advance(horizon)
                self._account(min(horizon, spec.duration_s))
                self.t = horizon
                self._track_control_plane(horizon)
            # Recovery bookkeeping past the last event: a blackout near
            # the end of the run still records its re-registrations.
            if self._outage_start is not None:
                tail = self._outage_end + spec.lease_ttl_s
                if self.t < tail:
                    self.t = tail
                self._track_control_plane(self.t)
        finally:
            loop.close()
        return self._report(arrivals)

    def _report(self, arrivals: list[Arrival]) -> FleetReport:
        spec = self.spec
        completed = shed = broken = tokens = 0
        ttfts: list[float] = []
        tpots: list[float] = []
        e2es: list[float] = []
        for rec in self.recs.values():
            arr = rec.arrival
            if rec.shed is not None:
                # A typed shed must be clean: no tokens ever streamed.
                shed += 1
                if rec.n_tokens:
                    broken += 1
                continue
            if rec.done and rec.n_tokens == arr.osl:
                completed += 1
                tokens += rec.n_tokens
                if rec.t_last is not None:
                    e2es.append(rec.t_last - arr.t)
                if rec.t_first is not None:
                    ttfts.append(rec.t_first - arr.t)
                    if (
                        arr.osl > 1
                        and rec.t_last is not None
                        and rec.t_last > rec.t_first
                    ):
                        tpots.append(
                            (rec.t_last - rec.t_first) / (arr.osl - 1)
                        )
            else:
                broken += 1
        total = len(arrivals)
        # SLO attainment over EVERY request: sheds and broken streams are
        # misses — unserved traffic cannot count as meeting the SLA.
        ok_ttft = sum(1 for v in ttfts if v <= spec.sla.ttft_s)
        ok_tpot = sum(1 for v in tpots if v <= spec.sla.itl_s)
        ttfts.sort()
        tpots.sort()
        e2es.sort()

        def pct(vals: list[float], q: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        return FleetReport(
            scenario=(
                ("planner" if spec.planner_on else "static")
                + ("+netroute" if spec.network_aware else "")
                + ("+disagg" if spec.disagg else "")
            ),
            duration_s=spec.duration_s,
            requests=total,
            completed=completed,
            shed=shed,
            broken_streams=broken,
            attainment_ttft=round(ok_ttft / total, 4) if total else 0.0,
            attainment_tpot=(
                round(ok_tpot / max(1, len(tpots)), 4) if tpots else 0.0
            ),
            goodput_tok_s=round(tokens / max(spec.duration_s, 1e-9), 1),
            ttft_p50_ms=round(pct(ttfts, 0.50) * 1e3, 1),
            ttft_p99_ms=round(pct(ttfts, 0.99) * 1e3, 1),
            tpot_p50_ms=round(pct(tpots, 0.50) * 1e3, 2),
            replica_seconds=round(self._replica_seconds, 1),
            mean_replicas=round(
                self._replica_seconds / max(spec.duration_s, 1e-9), 2
            ),
            peak_replicas=self._peak,
            decisions=dict(self.controller.decisions),
            scale_ups=self.connector.scale_ups,
            scale_downs=self.connector.scale_downs,
            drained_retired=self.retired_drained,
            migrations=self.migrations,
            placements=dict(self.placements),
            pulls_by_source=dict(self.pulls_by_source),
            failed_pulls=self.failed_pulls,
            streams=(
                {
                    rid: rec.tokens
                    for rid, rec in sorted(self.recs.items())
                }
                if spec.keep_streams
                else None
            ),
            model_flaps=self.model_flaps,
            blackout_routed=self.blackout_routed,
            blackout_shed=self.blackout_shed,
            reregister_lag_s=round(
                max(
                    (
                        self._rereg_delay(w)
                        for w in self._resynced
                    ),
                    default=0.0,
                ),
                3,
            ),
            kv_resyncs=len(self._resynced),
            e2e_p50_ms=round(pct(e2es, 0.50) * 1e3, 1),
            remote_prefills=self.remote_prefills,
            handoffs_streamed=self.handoffs_streamed,
            handoff_fallbacks=self.handoff_fallbacks,
            handoff_blocks=self.handoff_blocks,
        )


# -- the two headline A/Bs -------------------------------------------------


def default_tenants(
    scale: float = 1.0,
    users: int = 120_000,
    deadline_ms: float | None = 4000.0,
) -> list[TenantSpec]:
    """The standard diurnal multi-tenant mix: a big consumer tenant with
    the full 4x peak/trough swing, an enterprise tenant half a period out
    of phase, and a small bursty agent tenant. ``scale`` multiplies every
    rate; ``users`` sizes the consumer population."""
    return [
        TenantSpec(
            name="consumer",
            users=users,
            rps=18.0 * scale,
            diurnal_amplitude=0.6,
            diurnal_period_s=240.0,
            isl=64,
            osl=8,
            shared_prefix_tokens=32,
            deadline_ms=deadline_ms,
        ),
        TenantSpec(
            name="enterprise",
            users=max(1, users // 10),
            rps=8.0 * scale,
            diurnal_amplitude=0.6,
            diurnal_period_s=240.0,
            isl=96,
            osl=8,
            shared_prefix_tokens=64,
            deadline_ms=deadline_ms,
        ),
        TenantSpec(
            name="agents",
            users=max(1, users // 100),
            rps=4.0 * scale,
            burst_rps=12.0 * scale,
            burst_every_s=60.0,
            burst_len_s=10.0,
            isl=64,
            osl=8,
            shared_prefix_tokens=32,
            deadline_ms=deadline_ms,
        ),
    ]


def run_fleet_ab(
    tenants: list[TenantSpec] | None = None,
    duration_s: float = 360.0,
    seed: int = 0,
    sla: SlaTargets | None = None,
    max_replicas: int = 16,
    keep_streams: bool = False,
    chaos: list[ChaosEvent] | None = None,
) -> dict:
    """The autoscaling A/B: planner-on first (it discovers its own
    capacity trajectory), then a static pool frozen at the planner's
    MEAN replica count — the equal-budget baseline. Under the diurnal
    swing the same average capacity, fixed in time, starves the peak."""
    sla = sla or SlaTargets(ttft_s=0.35, itl_s=0.08)
    tenants = tenants or default_tenants()

    def spec(planner_on: bool, static: int = 0) -> FleetSpec:
        return FleetSpec(
            tenants=tenants,
            duration_s=duration_s,
            seed=seed,
            planner_on=planner_on,
            static_replicas=static,
            # Warm start at the t=0 load's requirement, like a real
            # autoscaler taking over a provisioned deployment — a cold
            # 1-2 worker start would charge the A/B for deployment
            # bring-up, which both scenarios are entitled to skip.
            initial_replicas=4,
            max_replicas=max_replicas,
            sla=sla,
            chaos=list(chaos or []),
            keep_streams=keep_streams,
        )

    planner = FleetHarness(spec(True)).run()
    budget = max(1, round(planner.mean_replicas))
    static = FleetHarness(spec(False, static=budget)).run()
    return {
        "planner": planner,
        "static": static,
        "static_budget_replicas": budget,
    }


def disagg_tenants(
    scale: float = 1.0,
    users: int = 40_000,
    diurnal_period_s: float = 240.0,
    deadline_ms: float | None = None,
) -> list[TenantSpec]:
    """The disagg A/B's long-prompt mix: prefill-heavy chat and RAG
    traffic (isl >> osl threshold for remote prefill) with the standard
    0.6-amplitude diurnal swing — a 4x peak/trough ratio. Long prompts
    are where disagg lives or dies: the KV transfer is tens of blocks,
    so serializing it behind prefill (the legacy pull) is visible in
    every stream's latency, and hiding it (streaming handoff) is the
    whole claim."""
    return [
        TenantSpec(
            name="chat",
            users=users,
            rps=6.0 * scale,
            diurnal_amplitude=0.6,
            diurnal_period_s=diurnal_period_s,
            isl=512,
            osl=32,
            shared_prefix_tokens=32,
            deadline_ms=deadline_ms,
        ),
        TenantSpec(
            name="rag",
            users=max(1, users // 10),
            rps=3.0 * scale,
            diurnal_amplitude=0.6,
            diurnal_period_s=diurnal_period_s,
            isl=384,
            osl=32,
            shared_prefix_tokens=64,
            deadline_ms=deadline_ms,
        ),
    ]


def run_disagg_ab(
    tenants: list[TenantSpec] | None = None,
    duration_s: float = 240.0,
    seed: int = 0,
    sla: SlaTargets | None = None,
    total_replicas: int = 6,
    prefill_fraction: float = 0.5,
    planner_on: bool = False,
    max_replicas: int = 16,
    chaos_disagg: list[ChaosEvent] | None = None,
    streaming: bool = True,
    max_local_prefill_tokens: int = 32,
    scheduling: str = "waves",
    max_num_seqs: int = 8,
    decode_us_per_seq: float = 500.0,
    pull_ms_per_block: float = 4.0,
    disagg_chunk_blocks: int = 8,
) -> dict:
    """The disagg-parity A/B (ISSUE 17): the same diurnal workload on an
    aggregated fleet and on a prefill/decode-split fleet at the SAME
    replica budget. Static mode (the deterministic parity audit) freezes
    both arms at ``total_replicas`` — equal budget by construction;
    planner mode runs the closed loop on both, per-pool on the disagg
    arm so the prefill:decode ratio shifts live with the swing.

    The parity claim: disagg end-to-end latency stays within a small
    factor of aggregated (the streaming handoff hides the transfer
    behind prefill), while TTFT attainment holds or improves — long
    prefills no longer ride the decode batch, so the 4x diurnal peak
    stops inflating first-token latency. Streams must be byte-identical
    between arms: disagg only moves WHERE tokens are computed.
    ``chaos_disagg`` applies to the disagg arm only (the sever-mid-
    handoff audit compares against a no-fault disagg run)."""
    sla = sla or SlaTargets(ttft_s=0.35, itl_s=0.08)
    tenants = tenants or disagg_tenants(diurnal_period_s=duration_s)

    def spec(disagg: bool, chaos: list[ChaosEvent] | None = None) -> FleetSpec:
        return FleetSpec(
            tenants=tenants,
            duration_s=duration_s,
            seed=seed,
            planner_on=planner_on,
            static_replicas=total_replicas,
            initial_replicas=total_replicas,
            max_replicas=max_replicas,
            max_num_seqs=max_num_seqs,
            decode_us_per_seq=decode_us_per_seq,
            pull_ms_per_block=pull_ms_per_block,
            sla=sla,
            disagg=disagg,
            prefill_fraction=prefill_fraction,
            streaming_handoff=streaming,
            max_local_prefill_tokens=max_local_prefill_tokens,
            disagg_chunk_blocks=disagg_chunk_blocks,
            scheduling=scheduling,
            chaos=list(chaos or []),
            keep_streams=True,
        )

    agg = FleetHarness(spec(False)).run()
    disagg = FleetHarness(spec(True, chaos_disagg)).run()
    return {"agg": agg, "disagg": disagg}


def run_blackout_ab(
    duration_s: float = 240.0,
    blackout_at: float = 90.0,
    blackout_s: float = 60.0,
    seed: int = 0,
    lease_ttl_s: float = 10.0,
    stale_grace_s: float = 120.0,
    scale: float = 0.5,
) -> dict:
    """The control-plane blackout A/B (ISSUE 15): one diurnal run with a
    sustained store outage in the middle, three ways —

    - ``no_fault``: the reference timeline (what every stream must match)
    - ``degraded``: stale-grace quarantine on (the ISSUE 15 path) — the
      blackout must be INVISIBLE to clients: streams bit-identical to
      no_fault, new requests route on cached instances, zero model
      flaps, and on recovery every worker re-registers within one lease
      TTL with its KV inventory resynced
    - ``strict``: grace = 0 (the pre-ISSUE-15 collapse) — lease expiry
      one TTL into the blackout drops every instance and new requests
      shed until recovery + re-registration, pinning that the degraded
      path is load-bearing

    The controller runs through its REAL degraded_hold path in the
    blackout scenarios (the observation window carries
    ``control_plane_degraded``)."""
    tenants = default_tenants(scale=scale, deadline_ms=None)

    def spec(chaos: list[ChaosEvent], grace: float) -> FleetSpec:
        return FleetSpec(
            tenants=tenants,
            duration_s=duration_s,
            seed=seed,
            planner_on=True,
            initial_replicas=4,
            max_replicas=8,
            lease_ttl_s=lease_ttl_s,
            discovery_stale_grace_s=grace,
            chaos=chaos,
            keep_streams=True,
        )

    outage = [ChaosEvent(t=blackout_at, action="store_outage", duration_s=blackout_s)]
    no_fault = FleetHarness(spec([], stale_grace_s)).run()
    degraded = FleetHarness(spec(list(outage), stale_grace_s)).run()
    strict = FleetHarness(spec(list(outage), 0.0)).run()
    return {"no_fault": no_fault, "degraded": degraded, "strict": strict}


def run_routing_ab(
    duration_s: float = 60.0,
    seed: int = 1,
    workers: int = 4,
    slow_worker: int = 0,
    slow_pull_ms: float = 25.0,
    fast_pull_ms: float = 0.2,
    background_rps: float = 6.0,
    slow_factor: float = 3.0,
) -> dict:
    """The NetKV A/B: a fixed fleet with one slow, LOADED peer that
    happens to hold the hottest shared prefix — ``slow_factor`` slower
    hardware, ``slow_pull_ms`` per block on the wire, and carrying
    ``background_rps`` of traffic from another frontend (visible only
    through the worker's reported queue metrics). Overlap-only routing
    keeps placing
    on it (best overlap; the out-of-band load is invisible to its cost)
    and keeps pulling from it (most blocks); the network-aware cost
    model measures its per-block pull latency and queue depth within a
    few transfers and shifts BOTH decisions to cheap, unloaded peers.
    Streams must be byte-identical either way — routing only moves
    where work lands."""
    tenants = [
        TenantSpec(
            name="shared",
            users=50_000,
            rps=24.0,
            isl=128,
            osl=6,
            shared_prefix_tokens=96,
        ),
    ]

    def run(aware: bool) -> FleetReport:
        spec = FleetSpec(
            tenants=tenants,
            duration_s=duration_s,
            seed=seed,
            planner_on=False,
            static_replicas=workers,
            network_aware=aware,
            # One queued request is roughly a prompt's worth of blocks
            # of pending work — weigh reported queue depth accordingly.
            queue_weight=float(tenants[0].isl // 8),
            worker_pull_ms={slow_worker: slow_pull_ms},
            worker_speed={slow_worker: slow_factor},
            pull_ms_per_block=fast_pull_ms,
            background_rps={slow_worker: background_rps},
            sla=SlaTargets(ttft_s=0.35, itl_s=0.08),
            keep_streams=True,
        )
        h = FleetHarness(spec)
        # Pre-warm the slow worker with the tenant's shared prefix so it
        # overlaps best from the first arrival (the trap overlap-only
        # scoring walks into). Token derivation mirrors workload.py.
        spt = tenants[0].shared_prefix_tokens
        prefix_len = spt - (spt % spec.block_size) or spec.block_size
        th = tenant_hue(tenants[0].name)
        prefix = [(th + i) % 251 for i in range(prefix_len)]
        hashes = compute_seq_hashes(prefix, spec.block_size)
        parents = [hashes[i - 1] if i else None for i in range(len(hashes))]
        h.workers[slow_worker].eng.import_peer_blocks(hashes, parents)
        return h.run()

    base = run(aware=False)
    aware = run(aware=True)
    return {"overlap_only": base, "network_aware": aware}

"""The port's fleet harness (``dynamo_tpu_torch/fleet``): the counterparts of
``tests/test_fleet.py`` (controller and netcost unit tests, the
autoscaling and routing A/Bs, the drain, kill and partition audits) but
its recorded-benchmark check, and of ``tests/test_fleet_disagg.py``, run
on the port's modules alone; and
scenarios run through both packages' harnesses with one seed, whose
reports are equal (placements, scaling decisions, virtual-clock TTFT and
TPOT, every request's ledger and the bytes of every token).
"""

import asyncio

import pytest

from dynamo_tpu_torch.fleet.harness import (
    ChaosEvent,
    FleetHarness,
    FleetSpec,
    default_tenants,
    disagg_tenants,
    mocker_profile,
    run_disagg_ab,
    run_routing_ab,
)
from dynamo_tpu_torch.fleet.workload import TenantSpec, generate_arrivals, rate_at
from dynamo_tpu_torch.llm.kv_router.netcost import (
    MAX_COST_RATIO,
    NetCostModel,
    NetworkAwareSelector,
    best_pull_source,
)
from dynamo_tpu_torch.llm.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.llm.kv_router.scheduler import DefaultWorkerSelector
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequences
from dynamo_tpu_torch.planner.controller import ControllerConfig, PlannerController
from dynamo_tpu_torch.planner.perf_interpolation import from_profile
from dynamo_tpu_torch.planner.planner_core import (
    Observation,
    Planner,
    PlannerConfig,
    RecordingConnector,
    SlaTargets,
)

# -- workload generator ------------------------------------------------------


def test_workload_deterministic_and_diurnal():
    spec = TenantSpec(
        name="t", users=10_000, rps=20.0, diurnal_amplitude=0.6,
        diurnal_period_s=100.0, isl=64, osl=8, shared_prefix_tokens=32,
    )
    a1 = generate_arrivals([spec], 50.0, seed=7)
    a2 = generate_arrivals([spec], 50.0, seed=7)
    assert [(a.t, a.rid, a.token_ids) for a in a1] == [
        (a.t, a.rid, a.token_ids) for a in a2
    ], "same seed must replay identically"
    a3 = generate_arrivals([spec], 50.0, seed=8)
    assert [a.t for a in a1] != [a.t for a in a3]
    # Amplitude 0.6 -> 4x peak/trough swing of the instantaneous rate.
    peak = max(rate_at(spec, t / 10) for t in range(1000))
    trough = min(rate_at(spec, t / 10) for t in range(1000))
    assert peak / trough == pytest.approx(4.0, rel=0.01)
    # Every arrival opens with the tenant's shared prefix; a recurring
    # user recurs with the same tail (the prefix-cache population).
    prefix = a1[0].token_ids[:32]
    assert all(a.token_ids[:32] == prefix for a in a1)
    by_user = {}
    recur = 0
    for a in a1:
        tail = a.token_ids[32:]
        if a.user in by_user:
            recur += 1
            assert by_user[a.user] == tail
        else:
            by_user[a.user] = tail
    assert recur > 0, "no user ever recurred — prefix reuse untested"


def test_workload_bursts():
    spec = TenantSpec(
        name="b", users=100, rps=2.0, burst_rps=20.0,
        burst_every_s=30.0, burst_len_s=5.0,
    )
    assert rate_at(spec, 2.0) == pytest.approx(22.0)
    assert rate_at(spec, 10.0) == pytest.approx(2.0)
    assert rate_at(spec, 32.0) == pytest.approx(22.0)


# -- controller --------------------------------------------------------------

PROFILE = {
    "prefill": {"isl": [128, 512, 2048, 8192], "ttft_s": [0.02, 0.06, 0.2, 0.9]},
    "decode": {"concurrency": [1, 8, 32, 64], "itl_s": [0.01, 0.012, 0.02, 0.045]},
}


def make_controller(clock, **cfg):
    p, d = from_profile(PROFILE)
    connector = RecordingConnector()
    planner = Planner(
        p, d, connector,
        sla=SlaTargets(ttft_s=0.2, itl_s=0.02),
        config=PlannerConfig(predictor="constant", max_replicas=32),
    )
    config = ControllerConfig(
        interval_s=10.0,
        scale_up_cooldown_s=cfg.pop("up_cd", 0.0),
        scale_down_cooldown_s=cfg.pop("down_cd", 0.0),
        down_stable_cycles=cfg.pop("stable", 2),
        max_step_up=cfg.pop("step_up", 4),
        max_step_down=cfg.pop("step_down", 1),
        max_replicas=32,
        **cfg,
    )
    ctl = PlannerController(planner, connector, config=config, clock=clock)
    return ctl, connector


def obs(rate=10.0, isl=512, osl=128, **kw):
    return Observation(request_rate=rate, mean_isl=isl, mean_osl=osl, **kw)


def test_controller_scales_pools_independently():
    """Prefill-heavy vs decode-heavy demand must move DIFFERENT pools —
    the disaggregated scaling contract from the reference planner."""
    t = [0.0]
    ctl, conn = make_controller(lambda: t[0])

    async def run():
        # Prefill-heavy: long prompts, tiny completions.
        t[0] += 100
        await ctl.cycle(obs(rate=30.0, isl=4096, osl=4))
        prefill_1 = ctl.pools["prefill"].target
        decode_1 = ctl.pools["decode"].target
        # Decode-heavy: short prompts, long completions.
        for _ in range(12):
            t[0] += 100
            await ctl.cycle(obs(rate=30.0, isl=64, osl=2048))
        return prefill_1, decode_1

    p1, d1 = asyncio.run(run())
    assert p1 > 1, "prefill pool ignored prefill-heavy demand"
    assert ctl.pools["decode"].target > d1, "decode pool ignored osl demand"
    assert ctl.pools["prefill"].target < p1, (
        "prefill pool never released after demand moved to decode"
    )
    comps = {c for c, _ in conn.calls}
    assert comps == {"prefill", "decode"}


def test_controller_hysteresis_blocks_single_trough():
    """One trough observation must never shed capacity; a sustained
    trough sheds one bounded step per cycle."""
    t = [0.0]
    ctl, _ = make_controller(lambda: t[0], stable=3)

    async def run():
        t[0] += 100
        await ctl.cycle(obs(rate=40.0))            # scale up
        high = ctl.pools["decode"].target
        assert high > 1
        t[0] += 100
        await ctl.cycle(obs(rate=1.0))             # single trough blip
        assert ctl.pools["decode"].target == high
        assert ctl.pools["decode"].last_action == "hysteresis_hold"
        t[0] += 100
        await ctl.cycle(obs(rate=1.0))
        assert ctl.pools["decode"].target == high  # 2/3 cycles
        t[0] += 100
        await ctl.cycle(obs(rate=1.0))             # 3rd: down, one step
        assert ctl.pools["decode"].target == high - 1
        assert ctl.pools["decode"].last_action == "scale_down"
        # A recovery resets the streak — no delayed shed.
        t[0] += 100
        await ctl.cycle(obs(rate=40.0))
        t[0] += 100
        await ctl.cycle(obs(rate=1.0))
        assert ctl.pools["decode"].last_action == "hysteresis_hold"

    asyncio.run(run())


def test_controller_cooldowns_and_bounded_steps():
    t = [1000.0]
    ctl, _ = make_controller(
        lambda: t[0], up_cd=30.0, down_cd=60.0, stable=1, step_up=2,
    )

    async def run():
        await ctl.cycle(obs(rate=100.0, osl=2048))   # huge demand
        first = ctl.pools["decode"].target
        assert first == 1 + 2, "scale-up exceeded max_step_up"
        t[0] += 10                                    # inside up cooldown
        await ctl.cycle(obs(rate=100.0, osl=2048))
        assert ctl.pools["decode"].target == first
        assert ctl.pools["decode"].last_action == "cooldown_hold"
        t[0] += 30                                    # cooldown expired
        await ctl.cycle(obs(rate=100.0, osl=2048))
        assert ctl.pools["decode"].target == first + 2
        # Down cooldown: two sustained-trough downs need 60 s apart.
        t[0] += 100
        await ctl.cycle(obs(rate=0.1))
        down1 = ctl.pools["decode"].target
        assert down1 == first + 1
        t[0] += 10
        await ctl.cycle(obs(rate=0.1))
        assert ctl.pools["decode"].target == down1
        assert ctl.pools["decode"].last_action == "cooldown_hold"

    asyncio.run(run())


def test_controller_reactive_pressure():
    """Queue backlog, typed sheds, and SLO-attainment misses must raise
    capacity above the rate math's answer — before the predictor
    notices."""
    t = [0.0]

    async def run_one(**obs_kw):
        ctl, _ = make_controller(lambda: t[0], queue_depth_per_replica=8.0)
        t[0] += 100
        await ctl.cycle(obs(rate=1.0, **obs_kw))
        return ctl

    # Rate alone at 1 rps: hold at 1.
    ctl = asyncio.run(run_one())
    assert ctl.pools["decode"].target == 1

    # Deep backlog: proportional catch-up, bounded by max_step_up.
    ctl = asyncio.run(
        run_one(queue_depth=200.0, live_workers={"decode": 1, "prefill": 1})
    )
    assert ctl.pools["decode"].target == 5     # 1 + max_step_up(4)
    assert ctl.pools["decode"].last_reason == "queue_depth"
    assert ctl.pools["decode"].desired >= 25   # backlog / 8, uncapped desire

    # A typed shed in the window: one full step of pressure.
    ctl = asyncio.run(run_one(shed_delta=3.0))
    assert ctl.pools["decode"].target == 5
    assert ctl.pools["decode"].last_reason == "sheds"

    # TPOT attainment miss pushes decode; TTFT miss pushes prefill.
    ctl = asyncio.run(run_one(slo_attainment={"ttft": 1.0, "tpot": 0.7}))
    assert ctl.pools["decode"].target == 2
    assert ctl.pools["decode"].last_reason == "slo_attainment"
    assert ctl.pools["prefill"].target == 1
    ctl = asyncio.run(run_one(slo_attainment={"ttft": 0.7, "tpot": 1.0}))
    assert ctl.pools["prefill"].target == 2
    assert ctl.pools["decode"].target == 1


def test_controller_status_and_stats_shapes():
    t = [0.0]
    ctl, _ = make_controller(lambda: t[0])

    async def run():
        t[0] += 100
        await ctl.cycle(obs(rate=30.0))

    asyncio.run(run())
    st = ctl.stats()
    assert st["cycles"] == 1
    assert set(st["decisions"]) == {
        "scale_up", "scale_down", "hold", "cooldown_hold", "hysteresis_hold",
        "degraded_hold",
    }
    assert st["decisions"]["scale_up"] >= 1
    pay = ctl.status_payload()
    assert pay["last_plan"]["predicted_rate"] == pytest.approx(30.0)
    assert pay["pools"]["decode"]["last_action"] == "scale_up"
    assert pay["last_observation"]["request_rate"] == pytest.approx(30.0)


# -- netcost -----------------------------------------------------------------


def test_netcost_ewma_and_ratio_clamp():
    m = NetCostModel(recompute_ms_per_block=2.0)
    m.observe_pull(7, blocks=10, elapsed_ms=10.0)      # 1 ms/block
    assert m.pull_ms_per_block(7) == pytest.approx(1.0)
    assert m.cost_ratio(7) == pytest.approx(0.5)
    # A failed pull charges its whole elapsed budget as one block.
    m.observe_pull(7, blocks=0, elapsed_ms=500.0, ok=False)
    assert m.pull_ms_per_block(7) > 100.0
    assert m.cost_ratio(7) == MAX_COST_RATIO           # clamped
    # Unmeasured peers get the optimistic prior, not infinity.
    assert m.cost_ratio(99) == pytest.approx(0.5 / 2.0, abs=0.2)


def test_netcost_folds_fleet_reports():
    """Every reporter's EWMA of a source folds into one pull-count
    weighted cost — the aggregated fleet view of a peer's link."""
    from dynamo_tpu_torch.llm.kv_router.protocols import (
        ForwardPassMetrics, KvStats, WorkerStats,
    )

    def fpm(waiting, net):
        return ForwardPassMetrics(
            worker_id=0,
            worker=WorkerStats(
                request_active_slots=0, request_total_slots=4,
                num_requests_waiting=waiting,
            ),
            kv=KvStats(
                kv_active_blocks=0, kv_total_blocks=64,
                gpu_cache_usage_perc=0.0, gpu_prefix_cache_hit_rate=0.0,
            ),
            net=net,
        )

    view = {
        1: fpm(3, {9: {"pulls": 3, "ms_per_block": 6.0}}),
        2: fpm(0, {9: {"pulls": 1, "ms_per_block": 2.0}}),
    }
    m = NetCostModel(recompute_ms_per_block=2.0, fleet_view=lambda: view,
                     cache_s=0.0)
    # (6*3 + 2*1) / 4 = 5.0
    assert m.pull_ms_per_block(9) == pytest.approx(5.0)
    assert m.queue_depth(1) == 3
    assert m.queue_depth(2) == 0
    assert m.snapshot()[9]["cost_ratio"] == pytest.approx(2.5)


def test_best_pull_source_prefers_cheap_useful_peer():
    m = NetCostModel(recompute_ms_per_block=2.0)
    m.observe_pull(1, 10, 40.0)     # 4 ms/block -> ratio 2: useless
    m.observe_pull(2, 10, 2.0)      # 0.2 ms/block -> ratio 0.1: cheap
    overlaps = {1: 12, 2: 8, 3: 2}  # peer 1 overlaps most but is slow
    src = best_pull_source(3, 2, overlaps, prompt_blocks=12, netcost=m)
    assert src is not None
    source, extra, ratio = src
    assert source == 2, "picked the expensive peer"
    assert extra == 6
    assert ratio == pytest.approx(0.1)
    # Every peer at ratio >= 1: no pull beats recomputing.
    m2 = NetCostModel(recompute_ms_per_block=2.0)
    m2.observe_pull(1, 10, 40.0)
    m2.observe_pull(2, 10, 80.0)
    assert best_pull_source(3, 0, {1: 12, 2: 8}, 12, m2) is None


def test_network_aware_selector_degrades_to_overlap_only():
    """With uniform (prior) costs, no queues, and no useful pulls the
    network-aware cost must pick exactly the overlap-only winner."""
    active = ActiveSequences(block_size=8)
    cfg = RouterConfig(temperature=0.0, block_size=8)
    overlaps = {1: 4, 2: 1, 3: 0}
    base = DefaultWorkerSelector().select_worker(
        [1, 2, 3], dict(overlaps), 64, active, cfg
    )
    m = NetCostModel(recompute_ms_per_block=2.0)
    aware = NetworkAwareSelector(m).select_worker(
        [1, 2, 3], dict(overlaps), 64, active, cfg
    )
    assert aware.worker_id == base.worker_id
    assert aware.overlap_blocks == base.overlap_blocks


def test_network_aware_selector_avoids_loaded_and_hints_cheap_source():
    from dynamo_tpu_torch.llm.kv_router.protocols import (
        ForwardPassMetrics, KvStats, WorkerStats,
    )

    def fpm(waiting):
        return ForwardPassMetrics(
            worker_id=0,
            worker=WorkerStats(
                request_active_slots=0, request_total_slots=4,
                num_requests_waiting=waiting,
            ),
            kv=KvStats(
                kv_active_blocks=0, kv_total_blocks=64,
                gpu_cache_usage_perc=0.0, gpu_prefix_cache_hit_rate=0.0,
            ),
        )

    # Worker 1 overlaps best but carries a deep queue; worker 2 is idle
    # and can pull the difference from cheap worker 3.
    view = {1: fpm(10), 2: fpm(0), 3: fpm(0)}
    m = NetCostModel(recompute_ms_per_block=2.0, fleet_view=lambda: view,
                     cache_s=0.0)
    m.observe_pull(3, 10, 2.0)      # worker 3: 0.2 ms/block, ratio 0.1
    active = ActiveSequences(block_size=8)
    cfg = RouterConfig(temperature=0.0, block_size=8, queue_weight=2.0)
    sel = NetworkAwareSelector(m).select_worker(
        [1, 2], {1: 8, 2: 0, 3: 8}, 64, active, cfg
    )
    assert sel.worker_id == 2, "queue depth ignored"
    assert sel.pull_hint is not None
    source, blocks = sel.pull_hint
    assert source == 3 and blocks == 8


# -- fleet harness e2e -------------------------------------------------------


def _mini_tenants():
    return default_tenants(scale=0.5, users=20_000)


def test_fleet_ab_planner_beats_equal_budget_static():
    """The test-scale autoscaling A/B (one diurnal period): the closed
    loop tracks the swing, the same mean budget frozen in time misses
    it. This guards the mechanism in tier-1."""
    def spec(on, static=0):
        return FleetSpec(
            tenants=default_tenants(), duration_s=240.0, seed=0,
            planner_on=on, static_replicas=static, initial_replicas=4,
            max_replicas=16, keep_streams=True,
        )

    planner = FleetHarness(spec(True)).run()
    budget = max(1, round(planner.mean_replicas))
    static = FleetHarness(spec(False, static=budget)).run()

    assert planner.broken_streams == 0 and static.broken_streams == 0
    assert planner.requests == static.requests > 5000
    assert planner.attainment_ttft >= 0.95, planner.summary()
    assert static.attainment_ttft < 0.85, static.summary()
    assert planner.attainment_ttft > static.attainment_ttft + 0.1
    # Equal budget, honestly: within 15% of the frozen pool.
    assert planner.mean_replicas <= budget * 1.15
    # The loop actually closed — both directions actuated, drains real.
    assert planner.scale_ups >= 2 and planner.scale_downs >= 2
    assert planner.drained_retired >= 1, planner.summary()
    assert planner.decisions["scale_up"] >= 2
    # Identical completed requests stream identical bytes across
    # scenarios (completions only — static sheds under the peak).
    compared = 0
    for rid, toks in planner.streams.items():
        other = static.streams.get(rid)
        if toks and other and len(other) == len(toks):
            assert other == toks, f"stream {rid} diverged across scenarios"
            compared += 1
    assert compared >= 1, "no completed request overlapped both scenarios"


def test_fleet_routing_ab_shifts_off_slow_peer():
    """NetKV at test scale: placement AND pulls shift off the slow,
    loaded peer; cohort TTFT improves; streams byte-identical."""
    r = run_routing_ab(duration_s=30.0)
    base, aware = r["overlap_only"], r["network_aware"]
    assert aware.streams == base.streams, "routing changed a stream"
    assert base.broken_streams == aware.broken_streams == 0
    slow = 0
    assert aware.pulls_by_source.get(slow, 0) * 4 <= base.pulls_by_source.get(slow, 1)
    assert aware.placements.get(slow, 0) * 2 <= base.placements.get(slow, 1)
    assert aware.ttft_p99_ms < base.ttft_p99_ms


def test_fleet_scale_down_drains_bit_identically():
    """Scale-down during active decode: the drained worker finishes
    every accepted stream before retiring, and the cohort's bytes match
    a run that never scaled at all."""
    tenants = [TenantSpec(name="t", users=500, rps=10.0, isl=32, osl=8,
                          shared_prefix_tokens=16)]

    def spec(chaos):
        return FleetSpec(
            tenants=tenants, duration_s=40.0, seed=3, planner_on=False,
            static_replicas=3, keep_streams=True, chaos=chaos,
        )

    baseline = FleetHarness(spec([])).run()
    h = FleetHarness(spec([ChaosEvent(t=15.0, action="drain", worker=1)]))
    drained = h.run()
    assert drained.broken_streams == 0
    assert drained.drained_retired == 1
    assert drained.streams == baseline.streams, (
        "drain changed client-visible bytes"
    )
    # The drained worker really was mid-work when told to go.
    w1 = [rid for rid, rec in h.recs.items() if 1 in rec.workers]
    assert w1, "worker 1 never held work — drain untested"
    # And no placements landed on it after the drain point.
    for rec in h.recs.values():
        if rec.arrival.t > 15.0:
            assert 1 not in rec.workers


def test_fleet_kill_during_scale_down_degrades_to_migration():
    """Chaos kill of a DRAINING worker mid-decode: the drain's
    completion promise degrades to the migration replay — streams
    still finish byte-identical to the no-fault run."""
    tenants = [TenantSpec(name="t", users=500, rps=20.0, isl=32, osl=8,
                          shared_prefix_tokens=16)]

    def spec(chaos):
        return FleetSpec(
            tenants=tenants, duration_s=40.0, seed=3, planner_on=False,
            static_replicas=3, keep_streams=True, chaos=chaos,
        )

    baseline = FleetHarness(spec([])).run()
    h = FleetHarness(spec([
        ChaosEvent(t=15.0, action="drain", worker=1),
        # 100 ms later, while the drain is mid-flight: kill the victim.
        ChaosEvent(t=15.1, action="kill", worker=-1),
    ]))
    killed = h.run()
    assert killed.migrations >= 1, "kill hit an already-empty worker"
    assert killed.broken_streams == 0
    assert killed.drained_retired == 0, "killed worker counted as drained"
    assert killed.streams == baseline.streams, (
        "kill-during-drain broke a stream"
    )


def test_fleet_partition_degrades_to_recompute():
    """A partitioned peer fails pulls (charged, measured) — requests
    recompute locally and every stream still completes identically."""
    tenants = [TenantSpec(name="t", users=300, rps=8.0, isl=64, osl=6,
                          shared_prefix_tokens=48)]

    def spec(chaos):
        return FleetSpec(
            tenants=tenants, duration_s=30.0, seed=5, planner_on=False,
            static_replicas=3, keep_streams=True, chaos=chaos,
        )

    baseline = FleetHarness(spec([])).run()
    cut = FleetHarness(spec([
        ChaosEvent(t=5.0, action="partition", worker=0, duration_s=20.0),
    ])).run()
    assert cut.failed_pulls > 0, "partition never intercepted a pull"
    assert cut.broken_streams == 0
    assert cut.streams == baseline.streams


def test_mocker_profile_matches_cost_model():
    prof = mocker_profile(20_000.0, 100.0, 5_000.0, 4)
    p, d = from_profile(prof)
    # One 128-token prefill iteration: 20 ms + 128*0.1 ms.
    assert p.ttft_at(128) == pytest.approx(0.0328)
    # One decode iteration at full batch: 20 ms + 4*5 ms.
    assert d.itl_at(4) == pytest.approx(0.040)


# -- the disaggregated topology (counterparts of tests/test_fleet_disagg.py) --


def _match_streams(a: dict, b: dict) -> int:
    """Assert byte-identity for every request that completed with the
    same length in both runs; return how many were compared."""
    compared = 0
    for rid, toks in a.items():
        other = b.get(rid)
        if toks and other and len(other) == len(toks):
            assert other == toks, f"stream {rid} diverged"
            compared += 1
    return compared


def test_disagg_ab_parity_ttft_and_byte_identity():
    """The headline acceptance: at EQUAL replica budget over
    the 4x diurnal swing, streaming disagg holds total latency within
    1.1x of aggregated, TTFT attainment at or above it, and every
    stream byte-identical — disagg only moves where tokens are
    computed."""
    r = run_disagg_ab(duration_s=90.0, seed=0)
    agg, dis = r["agg"], r["disagg"]
    # Equal budget by construction (both arms static at the same size).
    assert agg.replica_seconds == dis.replica_seconds
    assert agg.broken_streams == 0 and dis.broken_streams == 0
    assert agg.shed == 0 and dis.shed == 0
    # Total-latency parity: the streaming handoff hides the transfer.
    assert dis.e2e_p50_ms <= 1.1 * agg.e2e_p50_ms, (
        agg.summary(),
        dis.summary(),
    )
    # First-token attainment holds (long prefills left the decode batch).
    assert dis.attainment_ttft >= agg.attainment_ttft
    # The topology actually engaged: long prompts ran remote and every
    # handoff streamed.
    assert dis.remote_prefills > 100
    assert dis.handoffs_streamed == dis.remote_prefills
    assert dis.handoff_fallbacks == 0
    assert dis.handoff_blocks > 0
    assert agg.remote_prefills == 0
    compared = _match_streams(agg.streams, dis.streams)
    assert compared == agg.completed == dis.completed


def test_disagg_streaming_beats_legacy_pull():
    """The before/after of streaming: pull-after-prefill serializes
    the full KV transfer behind prefill and shows up in every stream's
    latency; the chunk-pipelined handoff leaves only the tail window in
    flight. Same fleet, same arrivals, byte-identical streams."""
    legacy = run_disagg_ab(duration_s=60.0, seed=1, streaming=False)
    stream = run_disagg_ab(duration_s=60.0, seed=1, streaming=True)
    leg, st, agg = legacy["disagg"], stream["disagg"], stream["agg"]
    assert leg.broken_streams == 0 and st.broken_streams == 0
    # Legacy is the measured liability; streaming is parity.
    assert st.e2e_p50_ms <= 1.1 * agg.e2e_p50_ms
    assert leg.e2e_p50_ms > 1.15 * agg.e2e_p50_ms, (
        "legacy pull no longer shows the serialization cost the "
        "streaming handoff exists to remove"
    )
    assert leg.e2e_p50_ms > st.e2e_p50_ms
    # Handoff mechanics identical apart from timing.
    assert leg.handoffs_streamed == st.handoffs_streamed
    assert leg.streams == st.streams, "handoff pacing changed bytes"


def test_disagg_sever_mid_handoff_bit_identical():
    """The degradation contract on the critical path: sever the
    prefill->decode links mid-run (every handoff in the window fails at
    a chunk boundary) — each affected request degrades to local
    recompute on its decode worker and completes bit-identically to the
    no-fault run."""
    base = run_disagg_ab(duration_s=60.0, seed=0)["disagg"]
    cut = run_disagg_ab(
        duration_s=60.0,
        seed=0,
        chaos_disagg=[
            # Workers 0-2 are the prefill pool (spawned first at
            # prefill_fraction=0.5 of 6).
            ChaosEvent(t=15.0, action="partition", worker=0, duration_s=15.0),
            ChaosEvent(t=15.0, action="partition", worker=1, duration_s=15.0),
            ChaosEvent(t=15.0, action="partition", worker=2, duration_s=15.0),
        ],
    )["disagg"]
    assert cut.handoff_fallbacks > 0, "sever window never hit a handoff"
    assert cut.failed_pulls >= cut.handoff_fallbacks
    assert cut.broken_streams == 0 and cut.shed == 0
    assert cut.streams == base.streams, (
        "sever mid-handoff changed client-visible bytes"
    )


def test_disagg_kill_mid_run_migrates_bit_identically():
    """Chaos kill of a prefill worker (mid-prompt work dies before any
    handoff) and of a decode worker (continuations die mid-stream):
    both degrade through the migration replay and every stream still
    matches the no-fault run."""
    base = run_disagg_ab(duration_s=60.0, seed=3)["disagg"]
    killed = run_disagg_ab(
        duration_s=60.0,
        seed=3,
        chaos_disagg=[
            ChaosEvent(t=20.0, action="kill", worker=0),   # prefill pool
            ChaosEvent(t=35.0, action="kill", worker=4),   # decode pool
        ],
    )["disagg"]
    assert killed.migrations >= 1, "kills hit empty workers — untested"
    assert killed.broken_streams == 0
    compared = _match_streams(base.streams, killed.streams)
    assert compared > 100


def test_disagg_planner_shifts_pool_ratio_live():
    """The planner scales the prefill and decode pools independently
    through the same controller the real fleet runs — the replica ratio
    tracks the diurnal swing instead of being frozen at deploy time."""
    spec = FleetSpec(
        tenants=disagg_tenants(scale=1.5, diurnal_period_s=90.0),
        duration_s=90.0,
        seed=0,
        planner_on=True,
        initial_replicas=6,
        min_replicas=2,
        max_replicas=12,
        disagg=True,
        prefill_fraction=0.5,
        scheduling="waves",
        max_num_seqs=8,
        decode_us_per_seq=500.0,
        pull_ms_per_block=4.0,
        disagg_chunk_blocks=8,
        sla=SlaTargets(ttft_s=0.35, itl_s=0.08),
        keep_streams=False,
    )
    h = FleetHarness(spec)
    report = h.run()
    assert report.broken_streams == 0
    prefill_sizes = {n for _, c, n in h.connector.calls if c == "prefill"}
    decode_sizes = {n for _, c, n in h.connector.calls if c == "decode"}
    # Both pools actuated, each through more than one size — the ratio
    # moved, it wasn't a fixed split scaled in lockstep.
    assert len(prefill_sizes) >= 2, h.connector.calls
    assert len(decode_sizes) >= 2, h.connector.calls
    ratios = {
        (np, nd)
        for (_, cp, np), (_, cd, nd) in zip(
            [x for x in h.connector.calls if x[1] == "prefill"],
            [x for x in h.connector.calls if x[1] == "decode"],
        )
    }
    assert len(ratios) >= 2, "prefill:decode ratio never shifted"
    roles = {w.role for w in h.workers}
    assert roles == {"prefill", "decode"}


def test_disagg_short_prompts_decode_locally():
    """Prompts at or under the remote-prefill threshold never leave the
    decode pool — and produce the same bytes as when everything runs
    remote (the threshold only moves where prefill happens)."""
    remote = run_disagg_ab(duration_s=30.0, seed=2)["disagg"]
    local = run_disagg_ab(
        duration_s=30.0, seed=2, max_local_prefill_tokens=100_000
    )["disagg"]
    assert remote.remote_prefills > 0
    assert local.remote_prefills == 0
    assert local.handoffs_streamed == 0
    assert local.broken_streams == 0
    compared = _match_streams(remote.streams, local.streams)
    assert compared > 0


# -- the JAX package's harness against the port's ------------------------------


def _ledger(h) -> dict:
    return {rid: (r.t_first, r.t_last, r.tokens, r.n_tokens, r.shed, r.finishes, r.workers,
                  r.done) for rid, r in h.recs.items()}


def _scenario(pkg: str, name: str):
    """One scenario through one package's harness: its reports, and for
    a single run every request's ledger."""
    import importlib

    hm = importlib.import_module(f"{pkg}.fleet.harness")
    wl = importlib.import_module(f"{pkg}.fleet.workload")
    if name == "planner-chaos":
        tenants = hm.default_tenants(scale=0.5, users=20_000) + [
            wl.TenantSpec(name="chat", users=400, rps=6.0, isl=64, osl=12,
                          shared_prefix_tokens=32)]
        h = hm.FleetHarness(hm.FleetSpec(
            tenants=tenants, duration_s=60.0, seed=11, planner_on=True,
            initial_replicas=3, max_replicas=8, keep_streams=True,
            chaos=[hm.ChaosEvent(t=20.0, action="kill", worker=2),
                   hm.ChaosEvent(t=25.0, action="partition", worker=0, duration_s=10.0),
                   hm.ChaosEvent(t=35.0, action="drain", worker=1),
                   hm.ChaosEvent(t=35.05, action="kill", worker=-1)],
        ))
        rep = h.run()
        return {"run": rep}, _ledger(h)
    if name == "routing":
        return hm.run_routing_ab(duration_s=20.0), None
    if name == "disagg":
        return hm.run_disagg_ab(duration_s=30.0, seed=2), None
    raise ValueError(name)


@pytest.mark.parametrize("name", ["planner-chaos", "routing", "disagg"])
def test_fleet_reports_match_jax_harness(name):
    want, want_ledger = _scenario("dynamo_tpu", name)
    got, got_ledger = _scenario("dynamo_tpu_torch", name)
    assert sorted(got) == sorted(want)
    for arm in want:
        w, g = want[arm], got[arm]
        assert g.summary() == w.summary(), arm
        assert g.streams == w.streams and w.streams, arm
        assert w.completed > 0
    assert got_ledger == want_ledger
    if name == "planner-chaos":
        rep = want["run"]
        assert rep.migrations >= 1
        assert sum(rep.decisions.values()) > 0 and rep.placements

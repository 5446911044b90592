"""The port's copies of the planner, the standalone aggregator, the
barrier, the KV-event recorder and the output parsers, each run beside
the JAX package's original on the same inputs.

The planner's plans and the controller's decisions equal the JAX
package's over one observation sequence; the port's fleet aggregator
feeds its planner the port's ``Observation`` (it named a module the port
lacked), equal to the JAX aggregator's on the same snapshots; the parsers
give the JAX parsers' outputs on ``tests/test_parsers.py``'s inputs; a
recording replayed into both radix trees leaves equal state; leader and
worker barriers meet over the port's store; ``python -m
dynamo_tpu_torch.obs --help`` exits 0.
"""

import asyncio
import dataclasses
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from dynamo_tpu import planner as jplanner
from dynamo_tpu.llm import parsers as jparsers
from dynamo_tpu.llm.kv_router.indexer import RadixTree as JaxRadixTree
from dynamo_tpu.llm.kv_router.recorder import replay_into as j_replay_into
from dynamo_tpu.obs.aggregator import FleetAggregator as JaxAggregator
from dynamo_tpu.obs.snapshot import MetricSnapshot as JaxSnapshot
from dynamo_tpu.planner import controller as jcontroller
from dynamo_tpu.planner.observer import parse_prometheus as j_parse_prometheus
from dynamo_tpu_torch import planner as tplanner
from dynamo_tpu_torch.llm import parsers as tparsers
from dynamo_tpu_torch.llm.kv_router.indexer import RadixTree
from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent
from dynamo_tpu_torch.llm.kv_router.recorder import KvEventRecorder, replay_events, replay_into
from dynamo_tpu_torch.obs.aggregator import FleetAggregator
from dynamo_tpu_torch.obs.snapshot import MetricSnapshot
from dynamo_tpu_torch.planner import controller as tcontroller
from dynamo_tpu_torch.planner.connector import LocalProcessConnector
from dynamo_tpu_torch.planner.observer import FleetMetricsObserver, parse_prometheus
from dynamo_tpu_torch.planner.planner_core import Observation

ROOT = Path(__file__).resolve().parents[1]
PROFILE = {  # tests/test_planner.py's profile
    "prefill": {"isl": [128, 512, 2048, 8192], "ttft_s": [0.02, 0.06, 0.2, 0.9]},
    "decode": {"concurrency": [1, 8, 32, 64], "itl_s": [0.01, 0.012, 0.02, 0.045]},
}


def _observations(pkg):
    """A sinusoidal rate with measured TTFT/ITL, queues, sheds, SLO
    attainment and one blind window, as ``pkg``'s Observation."""
    out = []
    for i, r in enumerate(10 + 9 * np.sin(np.linspace(0, 2 * math.pi, 40))):
        out.append(pkg.Observation(
            request_rate=float(r), mean_isl=512 + 8 * i, mean_osl=256,
            observed_ttft_s=0.05 + 0.01 * (i % 7) if i % 3 else None,
            observed_itl_s=0.015 + 0.002 * (i % 5) if i % 4 else None,
            phase_means={"tokenize": 0.001 * i} if i % 5 == 0 else None,
            queue_depth=float(60 * (i == 12) + i % 3),
            queue_depths={"decode": float(i % 3)} if i % 2 else None,
            shed_delta=float(i == 20),
            slo_attainment={"ttft": 0.8, "tpot": 0.99} if i == 25 else None,
            live_workers={"prefill": 1, "decode": 2},
            control_plane_degraded=i == 30,
        ))
    return out


def _planner(pkg, predictor):
    p, d = pkg.from_profile(PROFILE)
    return pkg.Planner(p, d, pkg.RecordingConnector(), sla=pkg.SlaTargets(ttft_s=0.2, itl_s=0.02),
                       config=pkg.PlannerConfig(predictor=predictor, max_replicas=32))


@pytest.mark.parametrize("predictor", ["constant", "moving_average", "ar"])
def test_planner_plans_equal_jax(predictor):
    """Predictors, interpolators, replica math and corrections: the same
    plans, applied to the same connector calls."""
    async def run(pkg):
        planner = _planner(pkg, predictor)
        plans = []
        for obs in _observations(pkg):
            if obs.control_plane_degraded:
                continue
            plan = planner.compute_plan(obs)
            await planner.apply(plan)
            plans.append(dataclasses.asdict(plan))
        return plans, planner.connector.calls

    got, want = asyncio.run(run(tplanner)), asyncio.run(run(jplanner))
    assert got == want
    assert len({p["decode_replicas"] for p in got[0]}) > 1  # it scaled


def test_interpolators_equal_jax():
    tp, td = tplanner.from_profile(PROFILE)
    jp, jd = jplanner.from_profile(PROFILE)
    for isl in (64, 128, 700, 5000, 10000):
        assert tp.ttft_at(isl) == jp.ttft_at(isl)
    for c in (1, 5, 40, 80):
        assert td.itl_at(c) == jd.itl_at(c) and td.throughput_at(c) == jd.throughput_at(c)
    assert tp.max_isl_within(0.2) == jp.max_isl_within(0.2)
    assert td.max_concurrency_within(0.02) == jd.max_concurrency_within(0.02)


@pytest.mark.parametrize("pools", [{"prefill": "prefill", "decode": "decode"}, {"backend": "max"}])
def test_controller_decisions_equal_jax(pools):
    """Hysteresis, cooldowns, bounded steps, reactive pressure and the
    blind-window hold on a virtual clock: the same actions, targets and
    counters."""
    async def run(pkg, ctl):
        now = [0.0]
        c = ctl.PlannerController(
            _planner(pkg, "constant"), pkg.RecordingConnector(), pools=dict(pools),
            config=ctl.ControllerConfig(pool_limits={"prefill": (1, 4)}), clock=lambda: now[0])
        actions = []
        for obs in _observations(pkg):
            actions.append(await c.cycle(obs))
            now[0] += 10.0
        return actions, c.stats(), c.connector.calls, c.status_payload()

    got = asyncio.run(run(tplanner, tcontroller))
    want = asyncio.run(run(jplanner, jcontroller))
    assert got == want
    assert {"degraded_hold", "scale_up"} <= {a for step in got[0] for a in step.values()}


def _feed(aggregator, snapshot_cls, clock):
    """Three windows of frontend, worker and phase snapshots."""
    now = time.time()
    out = []
    for seq, scale in ((1, 1.0), (2, 2.0), (3, 3.5)):
        aggregator.ingest(snapshot_cls(
            worker_id=9, seq=seq, t=now, role="frontend",
            families={"frontend": {
                "requests_total": 10.0 * scale, "isl_sum": 2560.0 * scale,
                "isl_count": 10.0 * scale, "osl_sum": 1280.0 * scale, "osl_count": 10.0 * scale,
                "ttft_sum": 1.0 * scale ** 2, "ttft_count": 10.0 * scale,
                "itl_sum": 0.5 * scale ** 2, "itl_count": 50.0 * scale,
            }},
            phases={"frontend/tokenize": (10.0 * scale, 0.1 * scale ** 2)}))
        for wid, comp in ((1, "prefill"), (2, "decode")):
            aggregator.ingest(snapshot_cls(
                worker_id=wid, seq=seq, t=now, component=comp,
                families={"scheduler": {"waiting": float(wid + seq), "shed_total": float(seq)}},
                phases={"engine/prefill": (5.0 * scale, 0.2 * scale)}))
        clock[0] += 5.0
        out.append(aggregator.observation())
    return out


def test_aggregator_feeds_the_planner_port_observations(monkeypatch):
    """``FleetAggregator.observation()`` in the port returns the port's
    ``Observation``, field for field the JAX aggregator's on the same
    snapshots (both on one virtual monotonic clock), and the port's
    ``FleetMetricsObserver`` hands it on."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    port = FleetAggregator(store=None, namespace="dynamo", stale_after_s=60.0)
    got = _feed(port, MetricSnapshot, clock)
    clock[0] = 1000.0
    want = _feed(JaxAggregator(store=None, namespace="dynamo", stale_after_s=60.0),
                 JaxSnapshot, clock)
    assert all(type(o) is Observation for o in got)
    assert [dataclasses.asdict(o) for o in got] == [dataclasses.asdict(o) for o in want]
    assert got[-1].request_rate > 0 and got[-1].queue_depths == {"prefill": 4.0, "decode": 5.0}
    seen = asyncio.run(FleetMetricsObserver(port).observe())
    assert type(seen) is Observation


def test_parse_prometheus_equals_jax():
    text = (
        "# HELP x y\n# TYPE dynamo_frontend_requests_total counter\n"
        'dynamo_frontend_requests_total{model="m"} 12\n'
        'dynamo_frontend_time_to_first_token_seconds_sum{model="m"} 1.5\n'
        'dynamo_frontend_time_to_first_token_seconds_count{model="m"} 3\n'
        'dynamo_phase_seconds_bucket{phase="prefill",le="0.1"} 4\n'
        "plain_gauge 7.25\n"
    )
    assert parse_prometheus(text) == j_parse_prometheus(text) != {}


def test_local_process_connector_scales_and_drains():
    """The connector starts the argv its caller gives and drains on
    scale-down (SIGTERM, exit codes recorded), as the JAX test checks."""
    async def scenario():
        conn = LocalProcessConnector(
            "unused:0", worker_argv={"w": ["-c", "import time; time.sleep(120)"]},
            drain_timeout_s=10.0)
        try:
            await conn.set_replicas("w", 2)
            assert conn.current("w") == 2
            await conn.set_replicas("w", 0)
            assert conn.current("w") == 0
            for _ in range(100):
                conn._reap_draining()
                if not conn.draining_count():
                    break
                await asyncio.sleep(0.05)
            return conn.exit_codes, conn.kills_escalated
        finally:
            conn.shutdown()

    codes, kills = asyncio.run(scenario())
    assert len(codes) == 2 and all(rc == -15 for _, rc in codes) and kills == 0


TOOL_CALLS = [
    ('Sure!\n<tool_call>\n{"name": "get_weather", "arguments": {"city": "SF"}}\n</tool_call>',
     "hermes"),
    ('<tool_call>{"name": "a", "arguments": {}}</tool_call>'
     '<tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>', "hermes"),
    ('[TOOL_CALLS][{"name": "search", "arguments": {"q": "tpu"}}]', "mistral"),
    ('<|python_tag|>{"name": "lookup", "parameters": {"id": 7}}', "llama3_json"),
    ('[get_weather(city="SF", units="c"), ping()]', "pythonic"),
    ("[1, 2, 3]", "pythonic"),
    ('<TOOLCALL>[{"name": "f", "arguments": {"k": 2}}]</TOOLCALL>', "nemotron"),
    ('{"name": "f", "arguments": "{\\"a\\": 1}"}', "json"),
    ("x", "nope"),
]


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))
    if dataclasses.is_dataclass(out):
        calls = [dataclasses.replace(c, id="") for c in getattr(out, "tool_calls", [])]
        return dataclasses.asdict(dataclasses.replace(out, tool_calls=calls)
                                  if hasattr(out, "tool_calls") else out)
    return out


@pytest.mark.parametrize("text, fmt", TOOL_CALLS, ids=[f for _, f in TOOL_CALLS])
def test_tool_call_parsers_equal_jax(text, fmt):
    got = _outcome(tparsers.parse_tool_calls, text, fmt)
    assert got == _outcome(jparsers.parse_tool_calls, text, fmt)
    if fmt != "nope":
        assert tparsers.detect_format(text) == jparsers.detect_format(text)


@pytest.mark.parametrize("text, fmt", [
    ("<think>step 1. step 2.</think>The answer is 4.", "deepseek_r1"),
    ("reasoning here</think>answer", "deepseek_r1"),
    ("<|channel|>analysis\nlet me think<|channel|>final\n42", "gpt_oss"),
    ("plain text answer", "deepseek_r1"),
])
def test_reasoning_parsers_equal_jax(text, fmt):
    assert _outcome(tparsers.parse_reasoning, text, fmt) == _outcome(
        jparsers.parse_reasoning, text, fmt)


def test_streaming_think_parser_equals_jax():
    for chunks in (["<thi", "nk>ab", "c</th", "ink>he", "llo"], ["just an answer"]):
        outs = []
        for pkg in (tparsers, jparsers):
            p = pkg.StreamingThinkParser()
            outs.append([p.feed(c) for c in chunks] + [p.flush()])
        assert outs[0] == outs[1]


def _events():
    rng = np.random.default_rng(3)
    out, eid = [], 0
    for w in (1, 2, 3):
        for _ in range(6):
            eid += 1
            chain = [int(h) for h in rng.integers(1, 40, rng.integers(1, 6))]
            out.append(RouterEvent(w, eid, KvCacheEvent("stored", tuple(chain), None)))
    out.append(RouterEvent(2, eid + 1, KvCacheEvent("removed", out[7].event.block_hashes[-1:],
                                                    None)))
    out.append(RouterEvent(3, eid + 2, KvCacheEvent("cleared", (), None)))
    return out


def test_recorder_replays_into_equal_trees(tmp_path):
    """A recording made by the port's recorder (directly and through an
    indexer tap) replays to the same events, and into the port's and the
    JAX package's radix trees with the same matches."""
    events = _events()
    path = tmp_path / "events.jsonl"

    class Indexer:
        tree = RadixTree()

    with KvEventRecorder(path) as rec:
        tap = rec.attach(Indexer)
        for ev in events:
            tap(ev)
    assert rec.recorded == len(events)
    assert [ev for _, ev in replay_events(path)] == events
    tree, jtree = RadixTree(), JaxRadixTree()
    assert replay_into(path, tree) == j_replay_into(path, jtree) == len(events)
    for ev in events:
        chain = list(ev.event.block_hashes)
        for n in range(1, len(chain) + 1):
            assert tree.find_matches(chain[:n]) == jtree.find_matches(chain[:n])
            assert Indexer.tree.find_matches(chain[:n]) == tree.find_matches(chain[:n])


async def test_barrier_meets_over_the_port_store():
    from dynamo_tpu_torch.runtime.barrier import LeaderBarrier, WorkerBarrier
    from dynamo_tpu_torch.runtime.store import StoreServer
    from dynamo_tpu_torch.runtime.store.client import StoreClient

    store = StoreServer()
    await store.start()
    client = await StoreClient.open(store.address)
    try:
        leader = LeaderBarrier(client, "init", num_workers=3)
        workers = [WorkerBarrier(client, "init", f"w{i}") for i in range(3)]
        lead = asyncio.create_task(leader.sync({"layout": "flat", "n": 7}))
        datas = await asyncio.gather(*(w.sync(timeout=10) for w in workers))
        assert sorted(await lead) == ["w0", "w1", "w2"]
        assert all(d == {"layout": "flat", "n": 7} for d in datas)
    finally:
        await client.close()
        await store.stop()


def test_obs_cli_help():
    out = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.obs", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--stale-after-s" in out.stdout

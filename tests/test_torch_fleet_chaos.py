"""Fleet-level tests of the port's control-plane copies through the port's
mocker, on the port's modules alone: counterparts of tests in
``tests/test_chaos.py`` (a worker killed or stalled mid-stream, a fused
megastep worker failing, a graceful drain, the mocker's replay base),
``tests/test_overload.py`` (fair scheduling, deadlines on the virtual
clock, a shed retried elsewhere) and ``tests/test_outage.py`` (a store
blackout on the fleet harness, degraded against strict).
"""

import asyncio
import time
from contextlib import suppress

import pytest

from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.mocker import MockEngineArgs, MockTpuEngine
from dynamo_tpu_torch.llm.protocols.common import (
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, chaos
from dynamo_tpu_torch.runtime.chaos import ChaosPlan, ChaosRule
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.store import StoreServer

# -- from tests/test_chaos.py ------------------------------------------------


def expected_tokens(n: int) -> list[int]:
    """The mocker's deterministic 'a'..'z' cycle — the no-fault stream."""
    return [97 + (i % 26) for i in range(n)]


def make_req(rid: str, max_tokens: int = 12) -> PreprocessedRequest:
    return PreprocessedRequest(
        model="mock",
        token_ids=[1, 2, 3, 4],
        request_id=rid,
        sampling=SamplingOptions(),
        stop=StopConditions(max_tokens=max_tokens),
    )


class Fleet:
    """Store + N mocker-engine workers + a routing client with the full
    migration pipeline — the minimal real-runtime fleet every chaos
    scenario runs against."""

    def __init__(
        self,
        n: int = 2,
        args: MockEngineArgs | None = None,
        stall_s: float | None = None,
    ):
        self.n = n
        self.args = args or MockEngineArgs(num_kv_blocks=512, block_size=8)
        self.stall_s = stall_s
        self.workers: list[tuple[DistributedRuntime, MockTpuEngine]] = []

    async def __aenter__(self) -> "Fleet":
        self.store = StoreServer()
        await self.store.start()
        for i in range(self.n):
            rt = await DistributedRuntime.create(self.store.address)
            engine = MockTpuEngine(self.args)
            engine.chaos_tag = f"w{i}"
            ep = rt.namespace("chaos").component("w").endpoint("generate")

            async def handler(req, ctx, engine=engine):
                async for out in engine.generate(req, ctx):
                    yield out

            await ep.serve(handler)
            self.workers.append((rt, engine))
        self.client_rt = await DistributedRuntime.create(self.store.address)
        if self.stall_s is not None:
            self.client_rt.egress.policy.stall_s = self.stall_s
        self.client = await (
            self.client_rt.namespace("chaos").component("w").endpoint("generate").client()
        )
        await self.client.wait_for_instances(self.n, timeout=10)
        self.migration = Migration(
            client=self.client, push_router=None, mode="round_robin", limit=3
        )
        return self

    async def __aexit__(self, *exc) -> None:
        chaos.uninstall()
        await self.client.stop()
        await self.client_rt.shutdown()
        for rt, _ in self.workers:
            with suppress(ConnectionError, OSError):
                await rt.shutdown()
        await self.store.stop()

    def serving_worker(self) -> tuple[DistributedRuntime, MockTpuEngine]:
        """The worker whose engine currently holds a running sequence."""
        for rt, engine in self.workers:
            if engine._running:
                return rt, engine
        raise AssertionError("no worker is serving")


async def test_worker_kill_mid_decode_bit_identical_stream():
    # ~20 ms per decode iteration so the kill reliably lands mid-stream.
    args = MockEngineArgs(num_kv_blocks=512, block_size=8, decode_us_per_seq=20000.0)

    # No-fault baseline first (fresh fleet: no shared state).
    async with Fleet(1, args, stall_s=5.0) as f:
        baseline = []
        async for out in f.migration.generate(make_req("base-1")):
            baseline.extend(out.token_ids)
    assert baseline == expected_tokens(12)

    async with Fleet(2, args, stall_s=5.0) as f:
        tokens: list[int] = []
        outs: list[LLMEngineOutput] = []
        killed = False
        async for out in f.migration.generate(make_req("kill-1")):
            tokens.extend(out.token_ids)
            outs.append(out)
            if not killed and len(tokens) >= 3:
                killed = True
                victim, _ = f.serving_worker()
                await victim.shutdown()  # worker dies with the stream in flight
        assert killed, "stream finished before the kill landed — slow the mocker"
        # Bit-identical to the no-fault run: nothing lost, nothing duplicated.
        assert tokens == baseline
        # Late-failure replay accounting: the replayed tokens are charged
        # once — prompt_tokens is the ORIGINAL prompt, completion_tokens
        # the full client-visible stream (not just the final attempt's).
        final = outs[-1]
        assert final.finish_reason is not None
        assert final.prompt_tokens == 4
        assert final.completion_tokens == 12


@pytest.mark.parametrize("action", ["kill", "stall"])
async def test_fused_megastep_worker_failure_bit_identical(action):
    args = MockEngineArgs(
        num_kv_blocks=512, block_size=8, decode_us_per_seq=20000.0,
        scheduling="chunked", prefill_chunk=8,
        megastep_k=8, spec_decode="ngram", spec_k=4,
    )

    # No-fault baseline first (fresh fleet: no shared state).
    async with Fleet(1, args, stall_s=5.0) as f:
        baseline: list[int] = []
        async for out in f.migration.generate(make_req("base-f", max_tokens=40)):
            baseline.extend(out.token_ids)
    assert baseline == expected_tokens(40)

    async with Fleet(2, args, stall_s=0.8) as f:
        tokens: list[int] = []
        hit = False
        async for out in f.migration.generate(make_req("fused-1", max_tokens=40)):
            tokens.extend(out.token_ids)
            if not hit and len(tokens) >= 3:
                hit = True
                victim_rt, victim = f.serving_worker()
                # The victim really is mid-fused-traffic: fused verify
                # dispatches ran (not plain single-step decode).
                assert victim.sched_stats["megastep_dispatches"] >= 1
                assert victim.sched_stats["fused_mixed_dispatches"] >= 1
                assert victim.spec_stats.verify_rows >= 1
                if action == "kill":
                    await victim_rt.shutdown()  # dies with the stream in flight
                else:
                    chaos.install(ChaosPlan([
                        ChaosRule(
                            point="engine.step", action="stall",
                            match=victim.chaos_tag, stall_s=60.0,
                        ),
                    ], seed=7))
        assert hit, "stream finished before the failure landed — slow the mocker"
        # Bit-identical to the no-fault run: the fused in-flight verify
        # rows were lost with the worker and replayed exactly.
        assert tokens == baseline


async def test_graceful_drain_finishes_inflight_and_deregisters():
    """As the JAX package's test, but the in-flight stream holds its last
    8 items until the late request has been refused, so the drain cannot
    finish first on a loaded host (where the original's 0.05 s pause can
    outlast the whole stream and the late request finds no route)."""
    async with StoreServer() as store:
        worker = await DistributedRuntime.create(store.address)
        client_rt = await DistributedRuntime.create(store.address)
        release = asyncio.Event()
        try:
            async def slow(request, context: Context):
                for i in range(10):
                    yield {"i": i}
                    if i == 1:
                        await release.wait()
                    await asyncio.sleep(0.02)

            ep = worker.namespace("t").component("w").endpoint("slow")
            await ep.serve(slow)
            client = await client_rt.namespace("t").component("w").endpoint("slow").client()
            await client.wait_for_instances(1, timeout=5)
            addr = worker.ingress.address

            stream = await client.round_robin({})
            got = [await stream.__anext__(), await stream.__anext__()]

            drain_task = asyncio.create_task(worker.drain(timeout=10.0))
            await asyncio.sleep(0.05)  # deregistration + draining flag land

            # New work is refused RETRYABLY (ConnectionError -> migration
            # replays elsewhere), not failed.
            late = await client_rt.egress.request(addr, "t/w/slow", {})
            with pytest.raises(ConnectionError, match="draining"):
                await late.__anext__()
            release.set()

            # The in-flight stream runs to completion — nothing lost.
            rest = [item async for item in stream]
            assert [g["i"] for g in got] + [r["i"] for r in rest] == list(range(10))

            assert await drain_task is True
            assert worker._shutdown.is_set()
            # Discovery is empty: the instance key was deleted up front.
            assert await client_rt.store.kv_get_prefix("/dynamo/instances/") == {}
        finally:
            await client_rt.shutdown()
            with suppress(ConnectionError, OSError):
                await worker.shutdown()


async def test_mocker_replay_base_continues_token_cycle():
    engine = MockTpuEngine(MockEngineArgs(num_kv_blocks=128, block_size=8))
    pre = PreprocessedRequest(
        model="mock", token_ids=[1, 2, 3, 4] + expected_tokens(5),
        request_id="replay-1", sampling=SamplingOptions(),
        stop=StopConditions(max_tokens=7), replayed_tokens=5,
    )
    tokens = []
    async for out in engine.generate(pre.to_wire(), Context()):
        tokens.extend(LLMEngineOutput.from_wire(out).token_ids)
    assert tokens == expected_tokens(12)[5:]



# -- from tests/test_overload.py ---------------------------------------------


def _mock_seq(rid, prompt, max_tokens, tenant, deadline=None):
    from dynamo_tpu_torch.llm.mocker.engine import _Seq
    from dynamo_tpu_torch.tokens import TokenBlockSequence, compute_seq_hashes

    s = _Seq(
        request_id=rid,
        prompt=prompt,
        max_tokens=max_tokens,
        out=asyncio.Queue(),
        seq=TokenBlockSequence(prompt, 8),
        prompt_hashes=compute_seq_hashes(prompt, 8),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
        tenant_id=tenant,
    )
    s.deadline_epoch = deadline
    return s


def _drive_mocker(fair, heavy_n, light_arrivals, max_vt=60.0):
    """Deterministic virtual-clock drive: a heavy tenant floods at t=0
    with short completions (slots turn over fast — admission order, not
    preemption, is what is under test), a light tenant arrives on a
    schedule; returns per-request first-token virtual times."""
    args = MockEngineArgs(
        num_kv_blocks=4096, block_size=8, max_num_seqs=2,
        max_num_batched_tokens=128, enable_prefix_caching=False,
        fair_scheduling=fair, fair_quantum=32,
    )
    eng = MockTpuEngine(args)
    heavy = [
        _mock_seq(f"h{i}", [1 + (i % 7)] * 32, 1, "heavy")
        for i in range(heavy_n)
    ]
    light = [
        _mock_seq(f"l{i}", [9] * 32, 4, "light")
        for i in range(len(light_arrivals))
    ]
    pending = sorted(
        zip(light_arrivals, light), key=lambda p: p[0]
    )
    for s in heavy:
        eng._waiting.append(s)
    vt = 0.0
    first: dict[str, float] = {}
    live = list(heavy)
    while vt < max_vt and (pending or any(
        s in eng._waiting or s in eng._running for s in live
    )):
        while pending and pending[0][0] <= vt:
            _, s = pending.pop(0)
            s.t_submit_vt = vt
            eng._waiting.append(s)
            live.append(s)
        eng._admit()
        p, d = eng._step()
        vt += (
            args.base_iter_us
            + p * args.prefill_us_per_token
            + d * args.decode_us_per_seq
        ) / 1e6
        for s in live:
            while not s.out.empty():
                item = s.out.get_nowait()
                if isinstance(item, dict) and item.get("token_ids"):
                    first.setdefault(s.request_id, vt)
    return {
        rid: t - getattr(
            next(s for s in live if s.request_id == rid), "t_submit_vt", 0.0
        )
        for rid, t in first.items()
    }


def test_mocker_fairness_bounds_light_tenant_ttft():
    """Acceptance: under a heavy-tenant flood, fairness on holds the
    light tenant's worst TTFT within 2x its unloaded value; FIFO does
    not. Deterministic mocker virtual clock."""
    arrivals = [0.02 * i for i in range(6)]
    unloaded = _drive_mocker(fair=False, heavy_n=0, light_arrivals=arrivals)
    fifo = _drive_mocker(fair=False, heavy_n=40, light_arrivals=arrivals)
    fair = _drive_mocker(fair=True, heavy_n=40, light_arrivals=arrivals)

    def light_worst(res):
        vals = [t for r, t in res.items() if r.startswith("l")]
        assert len(vals) == len(arrivals), f"light requests lost: {res}"
        return max(vals)

    u, f_on, f_off = light_worst(unloaded), light_worst(fair), light_worst(fifo)
    assert f_on <= 2.0 * u, (
        f"fair scheduling failed the SLO: worst light TTFT {f_on:.3f}s vs "
        f"unloaded {u:.3f}s"
    )
    assert f_off > 2.0 * u, (
        f"FIFO unexpectedly held the SLO ({f_off:.3f}s vs {u:.3f}s) — "
        "the load is not saturating; fix the test setup"
    )
    assert f_on < f_off


def test_mocker_deadline_expiry_on_virtual_clock():
    """Queued-past-deadline requests shed with the typed frame on the
    INJECTED clock; pins/partials fully released."""
    args = MockEngineArgs(
        num_kv_blocks=256, block_size=8, max_num_seqs=1,
        enable_prefix_caching=False,
    )
    eng = MockTpuEngine(args)
    clock = [1000.0]
    eng.clock = lambda: clock[0]
    running = _mock_seq("run", [1] * 16, 8, "")
    late = _mock_seq("late", [2] * 16, 8, "", deadline=1005.0)
    eng._waiting.append(running)
    eng._waiting.append(late)
    eng._admit()
    assert running in eng._running and late in eng._waiting
    clock[0] = 1010.0  # virtual deadline passes while queued
    eng._admit()
    assert late not in eng._waiting
    item = late.out.get_nowait()
    assert item["finish_reason"] == "error"
    assert item["meta"]["shed"] == "deadline"
    assert eng.sched_stats["deadline_expired_total"] == 1
    # Drain the running seq; every block returns.
    for _ in range(50):
        eng._admit()
        eng._step()
        if running not in eng._running:
            break
    assert eng.kv.free_blocks == eng.kv.capacity


async def test_shed_worker_retries_elsewhere_stream_intact():
    """A full worker's shed is the retry-elsewhere shape: migration
    moves the request to the other instance and the client stream is
    bit-identical to a clean run — zero broken streams."""
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.store import StoreServer

    store = StoreServer()
    await store.start()
    rts, engines = [], []
    try:
        for i, args in enumerate(
            (
                # Worker 0: one slot, slow, queue bounded at 1 -> sheds.
                MockEngineArgs(
                    num_kv_blocks=256, block_size=8, max_num_seqs=1,
                    max_waiting=1, decode_us_per_seq=200000.0,
                ),
                # Worker 1: healthy.
                MockEngineArgs(num_kv_blocks=256, block_size=8),
            )
        ):
            rt = await DistributedRuntime.create(store.address)
            engine = MockTpuEngine(args)
            ep = rt.namespace("ovl").component("w").endpoint("generate")

            async def handler(req, ctx, engine=engine):
                async for out in engine.generate(req, ctx):
                    yield out

            await ep.serve(handler)
            rts.append(rt)
            engines.append(engine)
        client_rt = await DistributedRuntime.create(store.address)
        client = await (
            client_rt.namespace("ovl").component("w").endpoint("generate").client()
        )
        await client.wait_for_instances(2, timeout=10)

        def req(rid, n=6):
            return PreprocessedRequest(
                model="mock", token_ids=[1, 2, 3, 4], request_id=rid,
                stop=StopConditions(max_tokens=n),
            )

        # Stuff worker 0: one running (slow), one queued (at the limit).
        ids = sorted(client.instance_ids())
        w0 = ids[0]
        s0 = await client.direct(w0, req("fill0", 400).to_wire())
        task0 = asyncio.create_task(s0.__anext__())
        for _ in range(200):
            await asyncio.sleep(0.005)
            if engines[0]._running:
                break
        s1 = await client.direct(w0, req("fill1", 4).to_wire())

        migration = Migration(
            client=client, push_router=None, mode="round_robin", limit=3
        )
        streams = []
        for i in range(4):
            toks = []
            async for out in migration.generate(req(f"m{i}", 6)):
                toks.extend(out.token_ids)
            streams.append(toks)
        expect = [97 + (i % 26) for i in range(6)]
        assert all(s == expect for s in streams), streams
        # At least one round-robin pick hit the stuffed worker and shed.
        assert engines[0].sched_stats["shed_total"] >= 1
        task0.cancel()
        with suppress(Exception):
            await task0
        with suppress(Exception):
            await s1.kill()
        await client.stop()
        await client_rt.shutdown()
    finally:
        for rt in rts:
            with suppress(ConnectionError, OSError):
                await rt.shutdown()
        await store.stop()



# -- from tests/test_outage.py -----------------------------------------------


def test_fleet_blackout_degraded_serves_strict_sheds():
    """60 s store blackout mid-diurnal-run:

    degraded mode — every stream bit-identical to the no-fault run, new
    requests during the blackout route on cached instances, zero model
    flaps, the controller holds (degraded_hold), and on recovery every
    worker re-registers within one lease TTL with inventories resynced;

    strict mode (grace = 0) — the SAME scenario demonstrably sheds once
    leases expire, pinning that the degraded path is load-bearing."""
    from dynamo_tpu_torch.fleet.harness import run_blackout_ab

    r = run_blackout_ab(
        duration_s=240.0, blackout_at=90.0, blackout_s=60.0,
        seed=3, lease_ttl_s=10.0, stale_grace_s=120.0,
    )
    no_fault, degraded, strict = r["no_fault"], r["degraded"], r["strict"]

    # Degraded mode: the blackout is invisible to clients.
    assert degraded.broken_streams == 0
    assert degraded.streams == no_fault.streams  # bit-identical fleet-wide
    assert degraded.blackout_routed >= 1
    assert degraded.blackout_shed == 0
    assert degraded.model_flaps == 0
    assert degraded.decisions.get("degraded_hold", 0) >= 1
    # Recovery: every blacked-out worker re-registered within one lease
    # TTL and resynced its KV inventory on session replay.
    assert degraded.kv_resyncs >= 1
    assert 0.0 < degraded.reregister_lag_s <= 10.0

    # Strict mode (grace = 0): lease expiry collapses routing — the same
    # scenario sheds new requests and flaps the model add/remove.
    assert strict.blackout_shed >= 1
    assert strict.model_flaps >= 2  # removed at expiry, re-added on recovery
    assert strict.shed >= strict.blackout_shed


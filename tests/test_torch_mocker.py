"""The port's mocker (``dynamo_tpu_torch/llm/mocker``): the counterparts of
``tests/test_mocker.py`` (the KV manager's lifecycle, prefix caching,
scheduling, events) and of the mocker's speculation tests in
``tests/test_spec_decode.py``, run on the port's modules alone; and the
same requests through the JAX package's ``MockTpuEngine`` and the port's,
with the same ``MockEngineArgs``: tokens, finish reasons, KV events, the
virtual clock and ``ForwardPassMetrics`` are equal, exactly.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from dynamo_tpu_torch.llm.mocker import MockEngineArgs, MockKvManager, MockTpuEngine
from dynamo_tpu_torch.llm.mocker.kv_manager import InsufficientBlocksError
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.tokens import compute_seq_hashes

pytestmark = [pytest.mark.unit, pytest.mark.pre_merge]

ROOT = Path(__file__).resolve().parents[1]

FAST = MockEngineArgs(
    num_kv_blocks=64,
    block_size=4,
    speedup_ratio=1000.0,
)


def make_request(tokens, max_tokens=8, request_id="r1"):
    return PreprocessedRequest(
        model="mock",
        token_ids=tokens,
        stop=StopConditions(max_tokens=max_tokens),
        request_id=request_id,
    ).to_wire()


# -- KV manager ---------------------------------------------------------------


def test_kv_manager_commit_and_release_to_lru():
    stored, removed = [], []
    kv = MockKvManager(
        num_blocks=4, block_size=4,
        on_stored=lambda h, p: stored.extend(h),
        on_removed=lambda h: removed.extend(h),
    )
    h = compute_seq_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    kv.allocate_partial(2)
    kv.commit_block(h[0], None)
    kv.commit_block(h[1], h[0])
    assert stored == h
    assert kv.match_prefix(h) == 2
    kv.release(h)
    # Released blocks stay cached (inactive LRU) — still matchable.
    assert kv.match_prefix(h) == 2
    assert removed == []


def test_kv_manager_eviction_under_pressure():
    removed = []
    kv = MockKvManager(num_blocks=2, block_size=4, on_removed=lambda h: removed.extend(h))
    h = compute_seq_hashes(list(range(8)), 4)
    kv.allocate_partial(2)
    kv.commit_block(h[0], None)
    kv.commit_block(h[1], h[0])
    kv.release(h)  # both inactive now
    kv.allocate_partial(2)  # requires evicting both LRU blocks
    assert removed == h
    assert kv.match_prefix(h) == 0


def test_kv_manager_insufficient_blocks():
    kv = MockKvManager(num_blocks=2, block_size=4)
    kv.allocate_partial(2)
    with pytest.raises(InsufficientBlocksError):
        kv.allocate_partial(1)


def test_kv_manager_dedup_on_commit():
    stored = []
    kv = MockKvManager(num_blocks=8, block_size=4, on_stored=lambda h, p: stored.extend(h))
    h = compute_seq_hashes([1, 2, 3, 4], 4)
    kv.allocate_partial(1)
    kv.commit_block(h[0], None)
    kv.allocate_partial(1)
    kv.commit_block(h[0], None)  # second seq, same content → dedup, no event
    assert stored == [h[0]]
    assert kv.used_blocks == 1


# -- engine -------------------------------------------------------------------


def test_kv_dtype_prices_halved_bytes_and_identical_tokens():
    """With the KV-read term priced, an int8 mocker's decode
    iterations cost ~0.52x the bf16 ones on the virtual clock (the
    DMA-bound decode model), while token VALUES are bit-identical; the
    default kv_read_us_per_block=0 keeps legacy timing untouched."""
    from dynamo_tpu_torch.engine.kv_quant import kv_byte_ratio
    from dynamo_tpu_torch.tokens import TokenBlockSequence
    from dynamo_tpu_torch.llm.mocker.engine import _Seq

    def run(kv_dtype, kv_us):
        args = MockEngineArgs(
            num_kv_blocks=256, block_size=4, max_num_seqs=4,
            enable_prefix_caching=False, kv_dtype=kv_dtype,
            kv_read_us_per_block=kv_us,
        )
        eng = MockTpuEngine(args)
        prompt = [1] * 16
        s = _Seq(
            request_id="s", prompt=prompt, max_tokens=8, out=asyncio.Queue(),
            seq=TokenBlockSequence(prompt, args.block_size),
            prompt_hashes=compute_seq_hashes(prompt, args.block_size),
            stop=StopConditions(max_tokens=8, ignore_eos=True),
        )
        eng._waiting.append(s)
        vt = 0.0
        toks = []
        while s in eng._waiting or s in eng._running:
            eng._admit()
            p, d = eng._step()
            vt += eng.iter_time_s(p, d, eng._last_kv_blocks_read)
            while not s.out.empty():
                item = s.out.get_nowait()
                if isinstance(item, dict):
                    toks.extend(item.get("token_ids") or [])
        return vt, toks

    t_bf, toks_bf = run("bf16", 100.0)
    t_i8, toks_i8 = run("int8", 100.0)
    assert toks_bf == toks_i8, "kv dtype changed token values"
    assert t_i8 < t_bf, "int8 KV reads were not priced cheaper"
    # The delta is exactly the byte ratio applied to the KV term.
    ratio = kv_byte_ratio("int8")
    t0, _ = run("bf16", 0.0)
    assert t_i8 - t0 == pytest.approx((t_bf - t0) * ratio, rel=1e-6)
    # And unpriced (default) int8 matches legacy timing exactly.
    assert run("int8", 0.0)[0] == pytest.approx(t0, rel=1e-9)
    # Gauges surface the dtype + halved bytes per block.
    st = MockTpuEngine(MockEngineArgs(kv_dtype="int8")).kv_cache_stats()
    st_bf = MockTpuEngine(MockEngineArgs()).kv_cache_stats()
    assert st["kv_dtype_int8"] == 1 and st_bf["kv_dtype_int8"] == 0
    assert st["bytes_per_block"] < st_bf["bytes_per_block"]


async def test_engine_generates_to_max_tokens():
    engine = MockTpuEngine(FAST)
    outs = [o async for o in engine.generate(make_request([1] * 10, max_tokens=6), Context())]
    tokens = [t for o in outs for t in o["token_ids"]]
    assert len(tokens) == 6
    assert outs[-1]["finish_reason"] == "length"
    assert outs[-1]["prompt_tokens"] == 10
    assert outs[0]["meta"]["cached_tokens"] == 0


async def test_engine_stop_token_ids_and_eos():
    # Mock decode emits 'a','b','c',... — stop on 'd' (the 4th token).
    engine = MockTpuEngine(FAST)
    req = PreprocessedRequest(
        model="mock",
        token_ids=[1] * 10,
        stop=StopConditions(max_tokens=20, stop_token_ids=[ord("d")]),
        request_id="stop1",
    ).to_wire()
    outs = [o async for o in engine.generate(req, Context())]
    assert [t for o in outs for t in o["token_ids"]] == [97, 98, 99, 100]
    assert outs[-1]["finish_reason"] == "stop"

    # EOS finishes unless ignore_eos; min_tokens defers it.
    engine = MockTpuEngine(FAST, eos_token_ids=(ord("b"),))
    req = PreprocessedRequest(
        model="mock",
        token_ids=[1] * 10,
        stop=StopConditions(max_tokens=20),
        request_id="eos1",
    ).to_wire()
    outs = [o async for o in engine.generate(req, Context())]
    assert outs[-1]["finish_reason"] == "eos"
    assert [t for o in outs for t in o["token_ids"]] == [97, 98]


async def test_engine_prefix_cache_hit_second_request():
    engine = MockTpuEngine(FAST)
    prompt = list(range(16))  # 4 full blocks
    out1 = [o async for o in engine.generate(make_request(prompt, 2, "a"), Context())]
    assert out1[0]["meta"]["cached_tokens"] == 0
    out2 = [o async for o in engine.generate(make_request(prompt, 2, "b"), Context())]
    assert out2[0]["meta"]["cached_tokens"] == 16  # all 4 blocks reused


async def test_engine_concurrent_requests_and_metrics():
    engine = MockTpuEngine(FAST)

    async def one(i):
        req = make_request([i] * 20, max_tokens=5, request_id=f"r{i}")
        return [o async for o in engine.generate(req, Context())]

    results = await asyncio.gather(*(one(i) for i in range(8)))
    assert all(sum(len(o["token_ids"]) for o in r) == 5 for r in results)
    m = engine.metrics()
    assert m.worker.request_active_slots == 0
    assert m.kv.kv_total_blocks == 64


async def test_engine_emits_kv_events():
    stored = []
    engine = MockTpuEngine(FAST)
    engine.kv.on_stored = lambda h, p: stored.extend(h)
    prompt = list(range(12))  # 3 blocks
    [o async for o in engine.generate(make_request(prompt, 5), Context())]
    want = compute_seq_hashes(prompt, 4)
    assert stored[: len(want)] == want  # prompt blocks stored in chain order
    # decode added 12+5=17 tokens → 4 complete blocks total
    assert len(stored) == 4


async def test_engine_cancellation_frees_blocks():
    engine = MockTpuEngine(FAST)
    ctx = Context()
    gen = engine.generate(make_request([1] * 40, max_tokens=1000), ctx)
    got = 0
    async for _ in gen:
        got += 1
        if got == 3:
            ctx.stop_generating()
    assert got < 1000
    for _ in range(200):
        if engine.kv.free_blocks == engine.kv.capacity:
            break
        await asyncio.sleep(0.01)
    # All blocks released (inactive LRU still holds hashes but is reclaimable)
    assert engine.kv.free_blocks == engine.kv.capacity


# -- speculation on the mocker (counterparts of tests/test_spec_decode.py) ----


def _mock_engine(spec_rate=None, **kw):
    args = MockEngineArgs(
        num_kv_blocks=512, block_size=4, max_num_batched_tokens=256,
        **(
            dict(spec_decode="ngram", spec_k=4, spec_acceptance_rate=spec_rate)
            if spec_rate is not None
            else {}
        ),
        **kw,
    )
    return MockTpuEngine(args)


def _mock_seq(prompt, rid, max_tokens, block_size, spec_k=0):
    from dynamo_tpu_torch.llm.mocker.engine import _Seq
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    s = _Seq(
        request_id=rid,
        prompt=prompt,
        max_tokens=max_tokens,
        out=asyncio.Queue(),
        seq=TokenBlockSequence(prompt, block_size),
        prompt_hashes=compute_seq_hashes(prompt, block_size),
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True),
    )
    s.spec_k = spec_k
    return s


def _drain_mock(eng, seq):
    toks, iters = [], 0
    eng._waiting.append(seq)
    eng._admit()
    while seq in eng._running:
        eng._step()
        iters += 1
        while not seq.out.empty():
            item = seq.out.get_nowait()
            if item is not MockTpuEngine._FINISHED:
                toks.extend(item.get("token_ids", []))
    return toks, iters


def test_mocker_spec_stream_bit_identical_and_fewer_iterations():
    base = _mock_engine()
    t0, i0 = _drain_mock(base, _mock_seq([1] * 8, "a", 30, 4))
    spec = _mock_engine(spec_rate=0.7)
    t1, i1 = _drain_mock(spec, _mock_seq([1] * 8, "a", 30, 4, spec_k=4))
    assert t0 == t1
    assert i1 < i0
    st = spec.spec_decode_stats()
    assert st["acceptance_rate"] > 0
    assert st["verify_steps"] > 0
    assert spec.metrics().spec_decode is not None


def test_mocker_spec_tpot_ab_on_virtual_clock():
    """At acceptance >= 0.5, decode TPOT on the mocker's virtual clock
    improves against speculation off (one dispatch amortizes over
    accepted + 1 tokens; draft tokens are priced like prefill tokens, so
    the win is net of the verify cost)."""

    def tpot(spec_rate):
        args = MockEngineArgs(
            num_kv_blocks=8192, block_size=32, max_num_seqs=32,
            max_num_batched_tokens=2048, enable_prefix_caching=False,
            **(
                dict(spec_decode="ngram", spec_k=4, spec_acceptance_rate=spec_rate)
                if spec_rate is not None
                else {}
            ),
        )
        eng = MockTpuEngine(args)
        seqs = [
            _mock_seq([1 + (j % 7)] * 128, f"s{j}", 64, 32,
                      spec_k=4 if spec_rate is not None else 0)
            for j in range(16)
        ]
        for s in seqs:
            eng._waiting.append(s)
        vt = 0.0
        first: dict[str, float] = {}
        gaps: list[float] = []
        prev: dict[str, float] = {}
        while any(s in eng._running or s in eng._waiting for s in seqs):
            eng._admit()
            p, d = eng._step()
            vt += (args.base_iter_us + p * args.prefill_us_per_token
                   + d * args.decode_us_per_seq) / 1e6
            for s in seqs:
                while not s.out.empty():
                    item = s.out.get_nowait()
                    if not isinstance(item, dict):
                        continue
                    n = len(item.get("token_ids", []))
                    if not n:
                        continue
                    rid = s.request_id
                    if rid in first:
                        # n tokens landed this step: n TPOT samples over the gap.
                        gaps.extend([(vt - prev[rid]) / n] * n)
                    first.setdefault(rid, vt)
                    prev[rid] = vt
        gaps.sort()
        return gaps[len(gaps) // 2], gaps[min(len(gaps) - 1, int(0.99 * len(gaps)))], vt

    off_p50, off_p99, off_total = tpot(None)
    on_p50, on_p99, on_total = tpot(0.6)
    assert on_p50 < off_p50, (on_p50, off_p50)
    assert on_total < off_total, (on_total, off_total)
    # A first-draft rejection pays the k verify forwards for one emitted
    # token, so p99 trades a bounded amount.
    assert on_p99 < off_p99 * 1.6, (on_p99, off_p99)
    # Below-threshold acceptance does not regress catastrophically.
    low_p50, _, low_total = tpot(0.2)
    assert low_p50 < off_p50 * 1.5
    assert low_total < off_total * 1.5


def test_mocker_per_request_spec_override():
    """The mocker honours ``PreprocessedRequest.spec_decode``, so frontend
    and router tests can exercise per-request speculation on the CPU."""
    from dynamo_tpu_torch.llm.protocols.common import SamplingOptions

    async def run():
        eng = MockTpuEngine(MockEngineArgs(num_kv_blocks=256, block_size=4, speedup_ratio=100.0))
        pre = PreprocessedRequest(
            model="tiny", token_ids=[1] * 8, request_id="r1",
            sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=12, ignore_eos=True),
            spec_decode={"method": "ngram", "k": 3},
        )
        toks = []
        async for out in eng.generate(pre.to_wire(), Context("r1")):
            toks.extend(out.get("token_ids", []))
        assert eng.spec_stats.verify_rows > 0
        assert len(toks) == 12
        if eng._loop_task is not None:
            eng._loop_task.cancel()
        return toks

    loop = asyncio.new_event_loop()
    try:
        toks = loop.run_until_complete(run())
    finally:
        loop.close()
    assert toks == [97 + (i % 26) for i in range(12)]


def test_mocker_device_draft_parity_and_amortization():
    """The device-drafted stream equals the host-drafted and spec-off
    streams, in fewer dispatches, with device rounds priced on the
    virtual clock."""

    def run(spec_rate, device):
        kw = dict(megastep_k=4)
        if spec_rate is not None:
            kw.update(spec_device_draft=device)
        eng = _mock_engine(spec_rate=spec_rate, **kw)
        seq = _mock_seq([1] * 8, "a", 30, 4, spec_k=4 if spec_rate is not None else 0)
        if spec_rate is not None:
            seq.spec_device = device
        toks, iters = _drain_mock(eng, seq)
        return eng, toks, iters

    _, t_base, i_base = run(None, False)
    _, t_host, i_host = run(0.9, False)
    eng, t_dev, i_dev = run(0.9, True)
    assert t_base == t_host == t_dev
    assert i_dev <= i_host <= i_base
    st = eng.spec_decode_stats()
    assert st["device_rounds"] > 0
    assert st["device_hits"] > 0
    assert st["dispatches_per_accepted_token"] > 0


# -- the JAX package's mocker against the port's ------------------------------

PARITY_ARGS = {
    "prefix-cache-pressure": dict(num_kv_blocks=24, block_size=4, max_num_seqs=4,
                                  max_num_batched_tokens=32),
    "chunked-prefill": dict(num_kv_blocks=256, block_size=8, max_num_seqs=8,
                            max_num_batched_tokens=24),
    "spec-megastep": dict(num_kv_blocks=512, block_size=4, max_num_batched_tokens=256,
                          megastep_k=4, spec_decode="ngram", spec_k=4,
                          spec_acceptance_rate=0.6, spec_device_draft=True),
    "int8-kv-priced": dict(num_kv_blocks=128, block_size=4, kv_dtype="int8",
                           kv_read_us_per_block=100.0, max_num_seqs=4),
}


def _parity_requests():
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(1, 500, 12)]
    reqs = []
    for i in range(7):
        tail = [int(t) for t in rng.integers(1, 500, int(rng.integers(3, 20)))]
        prompt = (shared if i % 2 else []) + tail
        stop = dict(max_tokens=int(rng.integers(4, 24)))
        if i == 3:
            stop["stop_token_ids"] = [ord("e")]
        if i == 5:
            stop["ignore_eos"] = True
        reqs.append((f"r{i}", prompt, stop))
    return reqs


def _drive_mocker(pkg: str, args_kw: dict, reqs, eos=(ord("q"),)) -> dict:
    """Every request admitted through ``_admit``/``_step`` of one package's
    mocker, synchronously: per step the (prefill, decode) token counts,
    the virtual-clock price and the metrics; per request its outputs; and
    the KV events in order."""
    import dataclasses
    import importlib

    engine_mod = importlib.import_module(f"{pkg}.llm.mocker.engine")
    tokens_mod = importlib.import_module(f"{pkg}.tokens")
    common = importlib.import_module(f"{pkg}.llm.protocols.common")
    eng = engine_mod.MockTpuEngine(engine_mod.MockEngineArgs(**args_kw), eos_token_ids=eos)
    events = []
    eng.kv.on_stored = lambda h, p: events.append(("stored", list(h), p))
    eng.kv.on_removed = lambda h: events.append(("removed", list(h)))
    bs = eng.args.block_size
    seqs = []
    for rid, prompt, stop in reqs:
        s = engine_mod._Seq(
            request_id=rid, prompt=list(prompt), max_tokens=stop["max_tokens"],
            out=asyncio.Queue(), seq=tokens_mod.TokenBlockSequence(prompt, bs),
            prompt_hashes=tokens_mod.compute_seq_hashes(prompt, bs),
            stop=common.StopConditions(**stop),
        )
        s.spec_k = eng.args.spec_k if eng.args.spec_decode == "ngram" else 0
        s.spec_device = eng.args.spec_device_draft
        seqs.append(s)
        eng._waiting.append(s)
    outs = {s.request_id: [] for s in seqs}
    steps = []
    for _ in range(2000):
        if not any(s in eng._waiting or s in eng._running for s in seqs):
            break
        eng._admit()
        p, d = eng._step()
        m = dataclasses.asdict(eng.metrics())
        steps.append((p, d, eng.iter_time_s(p, d, eng._last_kv_blocks_read), m))
        for s in seqs:
            while not s.out.empty():
                item = s.out.get_nowait()
                if isinstance(item, dict):
                    outs[s.request_id].append(item)
    else:
        raise AssertionError(f"{pkg}: requests never finished")
    return {"outs": outs, "steps": steps, "events": events,
            "sched": eng.scheduler_stats(), "kv": eng.kv_cache_stats(),
            "spec": eng.spec_decode_stats()}


@pytest.mark.parametrize("name", sorted(PARITY_ARGS))
def test_mocker_matches_jax_mocker(name):
    reqs = _parity_requests()
    want = _drive_mocker("dynamo_tpu", PARITY_ARGS[name], reqs)
    got = _drive_mocker("dynamo_tpu_torch", PARITY_ARGS[name], reqs)
    for rid, _, _ in reqs:
        w, g = want["outs"][rid], got["outs"][rid]
        assert [o.get("token_ids") for o in g] == [o.get("token_ids") for o in w], rid
        assert [o.get("finish_reason") for o in g] == [o.get("finish_reason") for o in w], rid
        assert g == w, rid
        assert any(o.get("finish_reason") for o in w), rid
    assert got["events"] == want["events"] and want["events"]
    assert got["steps"] == want["steps"]
    assert got["sched"] == want["sched"] and got["kv"] == want["kv"]
    assert got["spec"] == want["spec"]


# -- the mocker worker process (python -m dynamo_tpu_torch.backends.mocker) ----


def _help(module: str) -> str:
    out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, "COLUMNS": "100"})
    assert out.returncode == 0, out.stderr
    return out.stdout.replace(module, "MODULE")


def test_mocker_cli_takes_every_flag_of_the_jax_mocker():
    assert _help("dynamo_tpu_torch.backends.mocker") == _help("dynamo_tpu.backends.mocker")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for_port(port: int, proc, timeout=60.0) -> None:
    t0 = time.time()
    while time.time() - t0 < timeout:
        assert proc.poll() is None, f"{proc.args} exited before listening on {port}"
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return
        time.sleep(0.1)
    raise TimeoutError(f"nothing listened on port {port}")


def test_mocker_worker_process_behind_port_frontend(tmp_path):
    """No card and no model: the port's store, two mocker worker processes
    and the port's frontend, KV routing. A chat completion streams the
    mocker's ``abc…`` text, and its repeat reports the prompt's cached
    blocks."""
    import aiohttp

    store_port, http_port = _free_port(), _free_port()
    env = {**os.environ, "DYN_STORE_ADDRESS": f"127.0.0.1:{store_port}",
           "DYN_SYSTEM_ENABLED": "0"}

    def spawn(args, name):
        return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                stdout=(tmp_path / f"{name}.log").open("w"),
                                stderr=subprocess.STDOUT)

    procs = [spawn(["dynamo_tpu_torch.runtime.store", "--port", str(store_port)], "store")]
    base = f"http://127.0.0.1:{http_port}"
    body = {"model": "mock", "max_tokens": 8, "stream": True,
            "messages": [{"role": "user", "content": "a long enough question " * 8}]}

    async def chat(s) -> tuple[str, dict]:
        text, usage = "", {}
        async with s.post(f"{base}/v1/chat/completions",
                          json={**body, "stream_options": {"include_usage": True}}) as r:
            assert r.status == 200, await r.text()
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                chunk = json.loads(line[6:])
                for c in chunk.get("choices") or []:
                    text += c["delta"].get("content") or ""
                usage = chunk.get("usage") or usage
        return text, usage

    async def go():
        async with aiohttp.ClientSession() as s:
            for _ in range(300):
                try:
                    async with s.get(f"{base}/v1/models") as r:
                        if r.status == 200 and "mock" in await r.text():
                            break
                except aiohttp.ClientError:
                    pass
                await asyncio.sleep(0.1)
            else:
                raise TimeoutError("the model was never listed")
            first = await chat(s)
            await asyncio.sleep(0.5)  # the first request's KV events reach the router
            return first, await chat(s)

    try:
        _wait_for_port(store_port, procs[0])
        procs.append(spawn(["dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1",
                            "--http-port", str(http_port), "--router-mode", "kv"], "frontend"))
        _wait_for_port(http_port, procs[1])
        for i in range(2):
            procs.append(spawn(["dynamo_tpu_torch.backends.mocker", "--model-name", "mock",
                                "--speedup-ratio", "50"], f"worker{i}"))
        (text, _), (again, usage) = asyncio.run(go())
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(20)
            except subprocess.TimeoutExpired:
                p.kill()
    assert text == again == "abcdefgh"
    assert usage["prompt_tokens_details"]["cached_tokens"] > 0, usage

"""The port's host and disk KV tiers against the JAX package's, on the CPU.

The same weights (``engine/convert.py``) and the same traffic go through
the JAX ``EngineCore`` and the port's, each with a small device pool and
a host (and disk) tier behind it, as ``tests/test_host_kv_tier.py`` drives
the JAX engine alone: noise pushes a prompt's blocks off the device, a
repeat of the prompt onboards them. Greedy streams must be identical
between the engines and equal to a run without memory pressure, the tier
counters and the KV events identical, and a page's bytes identical before
eviction, in the host tier, and after onboarding (bf16 pages as their raw
16-bit words, int8 pages as the packed buffer). The offload worker lands
pages off the step, and onboarding writes into the cache tensors in
place (the card's CUDA graphs hold their addresses).
"""

import dataclasses
import threading
import time
from collections import Counter

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.engine.kv_quant import pack_kv_page
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

PROMPT = list(range(7, 7 + 40))
PRESSURE = {"num_kv_blocks": 24, "max_model_len": 128}


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), j_tiny_model())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")
    return jparams, tparams


def _wire(prompt, rid, max_tokens):
    return {"model": "tiny", "token_ids": list(prompt), "request_id": rid,
            "sampling": {"temperature": 0.0}, "stop": {"max_tokens": max_tokens}}


class Pair:
    """A JAX core and a port core on the same weights and engine shape,
    each with its own KV event log (and, under ``disk_root``, its own disk
    tier directory: the two packages' files are not shared)."""

    def __init__(self, weights, tier_aware=False, model_dtype=None, disk_root=None,
                 **engine_kw):
        self.events = {"jax": [], "torch": []}

        def hooks(kind):
            log = self.events[kind]
            out = {
                "on_stored": lambda hs, parent: log.append(("stored", "device", tuple(hs))),
                "on_removed": lambda hs: log.append(("removed", "device", tuple(hs))),
            }
            if tier_aware:
                out["on_tier_stored"] = lambda hs, p, tier: log.append(("stored", tier, tuple(hs)))
                out["on_tier_removed"] = lambda hs, tier: log.append(("removed", tier, tuple(hs)))
            return out

        jcfg, tcfg = j_tiny_model(), tiny_model()
        jparams, tparams = weights
        if model_dtype is not None:
            jcfg = dataclasses.replace(jcfg, dtype=model_dtype)
            tcfg = dataclasses.replace(tcfg, dtype=model_dtype)
            jparams = jax.tree.map(lambda a: a.astype(jcfg.jax_dtype), jparams)
            tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")

        def kw(kind):
            return dict(engine_kw, disk_kv_dir=str(disk_root / kind)) if disk_root else engine_kw

        self.jax = JaxCore(jcfg, j_tiny_engine(**kw("jax")), params=jparams, seed=0,
                           **hooks("jax"))
        self.torch = EngineCore(tcfg, tiny_engine(**kw("torch")), params=tparams, seed=0,
                                device="cpu", **hooks("torch"))

    def run(self, wires):
        """The same requests through both cores; (streams, sequences) of each."""
        out = {}
        for kind, core, from_wire in (("jax", self.jax, JaxRequest.from_wire),
                                      ("torch", self.torch, PreprocessedRequest.from_wire)):
            seqs = [core.add_request(from_wire(w)) for w in wires]
            toks = {s.request_id: [] for s in seqs}
            for _ in range(2000):
                if not core.has_work():
                    break
                for seq, o in core.step():
                    toks[seq.request_id].extend(o.token_ids)
            assert not core.has_work(), f"{kind} core did not finish"
            out[kind] = (toks, seqs)
        return out

    def noise(self, n_requests=6, tag=1000):
        rng = np.random.RandomState(tag)
        wires = [_wire([int(t) for t in rng.randint(1, 300, size=40)], f"noise-{tag}-{i}", 4)
                 for i in range(n_requests)]
        got = self.run(wires)
        assert got["jax"][0] == got["torch"][0]

    def flush(self):
        self.jax.offload.flush()
        self.torch.offload.flush()

    def stats(self, tier):
        pools = {"host": (self.jax.host_pool, self.torch.host_pool),
                 "disk": (self.jax.disk_pool, self.torch.disk_pool)}[tier]
        return [(p.stats.offloads, p.stats.onboards, p.stats.evictions, len(p)) for p in pools]


def _reference(weights, rid="ref", max_tokens=6, prompt=PROMPT):
    """The prompt's stream without memory pressure, on both engines."""
    got = Pair(weights).run([_wire(prompt, rid, max_tokens)])
    assert got["jax"][0] == got["torch"][0]
    return got["torch"][0][rid]


def _bytes(page) -> bytes:
    """A sliced page's canonical host bytes (int8: the packed buffer)."""
    if isinstance(page, dict):
        return pack_kv_page(np.asarray(page["kv"]), np.asarray(page["scale"])).tobytes()
    return np.asarray(page).tobytes()


def _page(core, bid) -> bytes:
    return _bytes(core._slice_page(bid))


def _jax_page(core, bid) -> bytes:
    import jax.numpy as jnp

    return _bytes(core._slice_page(core.cache, jnp.int32(bid)))


def test_offload_and_onboard_roundtrip_matches_jax(weights):
    ref = _reference(weights)
    pair = Pair(weights, host_kv_blocks=64, **PRESSURE)
    pair.run([_wire(PROMPT, "a", 6)])
    pair.noise()
    pair.flush()
    host = pair.stats("host")
    assert host[0] == host[1] and host[1][0] > 0, host
    got = pair.run([_wire(PROMPT, "b", 6)])
    assert got["jax"][0] == got["torch"][0] == {"b": ref}
    assert pair.torch.host_pool.stats.onboards > 0
    assert pair.stats("host")[0] == pair.stats("host")[1]
    cached = [s.num_cached_tokens for s in (got["jax"][1][0], got["torch"][1][0])]
    assert cached[0] == cached[1] > 0


def test_host_pool_lru_eviction_events_match_jax(weights):
    pair = Pair(weights, host_kv_blocks=4, **PRESSURE)
    pair.noise(8, tag=1)
    pair.noise(8, tag=2)
    pair.flush()
    host = pair.stats("host")
    assert host[0] == host[1] and host[1][2] > 0
    assert pair.events["torch"] == pair.events["jax"]
    removed = [h for op, _, hs in pair.events["torch"] if op == "removed" for h in hs]
    assert len(removed) >= pair.torch.host_pool.stats.evictions
    dupes = {h: c for h, c in Counter(removed).items() if c > 1}
    assert not dupes, f"removed emitted more than once: {dupes}"


def test_tiers_off_by_default_and_disk_needs_host(weights):
    pair = Pair(weights)
    assert pair.torch.host_pool is None and pair.torch.offload is None
    with pytest.raises(ValueError, match=r"disk_kv_dir \(G3\) requires host_kv_blocks > 0"):
        EngineCore(tiny_model(), tiny_engine(disk_kv_dir="kv"), params=weights[1], device="cpu")


def test_disk_tier_roundtrip_matches_jax(weights, tmp_path):
    prompt = list(range(11, 11 + 40))
    ref = _reference(weights, prompt=prompt)
    pair = Pair(weights, host_kv_blocks=4, disk_kv_blocks=256, disk_root=tmp_path, **PRESSURE)
    pair.run([_wire(prompt, "a", 6)])
    pair.noise(8)
    pair.noise(8, tag=2000)
    pair.flush()
    disk = pair.stats("disk")
    assert disk[0] == disk[1] and disk[1][0] > 0, disk
    got = pair.run([_wire(prompt, "b", 6)])
    assert got["jax"][0] == got["torch"][0] == {"b": ref}
    assert pair.torch.disk_pool.stats.onboards > 0
    assert pair.stats("disk")[0] == pair.stats("disk")[1]
    assert pair.events["torch"] == pair.events["jax"]


def test_disk_tier_eviction_events_match_jax(weights, tmp_path):
    pair = Pair(weights, host_kv_blocks=4, disk_kv_blocks=4, disk_root=tmp_path, **PRESSURE)
    for tag in (1, 2, 3):
        pair.noise(8, tag=tag)
    pair.flush()
    assert pair.stats("disk")[0] == pair.stats("disk")[1]
    assert pair.stats("host")[0] == pair.stats("host")[1]
    t = pair.torch
    assert t.disk_pool.stats.evictions > 0
    assert t.host_pool.stats.evictions >= t.disk_pool.stats.offloads
    assert pair.events["torch"] == pair.events["jax"]


@pytest.mark.parametrize("model_dtype, kv_dtype", [("float32", "bf16"), ("bfloat16", "bf16"),
                                                   ("float32", "int8")],
                         ids=["f32-pages", "bf16-pages", "int8-pages"])
def test_onboard_roundtrip_preserves_bytes_and_event_accounting(weights, model_dtype, kv_dtype):
    """Evict to the host tier and onboard back: the host tier holds the
    device page's exact bytes (bf16 as uint16 words, int8 packed), the
    onboarded page is that page again, written into the SAME cache
    tensors; stored fires once per block, removed never; the streams are
    the JAX engine's (bf16: the port's own no-pressure stream, since bf16
    rounds differently on the two CPUs)."""
    pair = Pair(weights, model_dtype=model_dtype, kv_dtype=kv_dtype,
                host_kv_blocks=64, **PRESSURE)
    core = pair.torch
    first = pair.run([_wire(PROMPT, "a", 4)])
    s1 = first["torch"][1][0]
    bs = core.engine.block_size
    cap = (len(PROMPT) - 1) // bs
    prefix = s1.prompt_hashes[:cap]
    byte0 = {h: _page(core, core.allocator._by_hash[h].block_id) for h in prefix}
    if model_dtype == "float32":
        jbyte0 = {h: _jax_page(pair.jax, pair.jax.allocator._by_hash[h].block_id) for h in prefix}
        assert [len(b) for b in byte0.values()] == [len(b) for b in jbyte0.values()]
    if kv_dtype == "int8":
        assert core.kv_wire_dtype == "int8"
        assert len(next(iter(byte0.values()))) == (
            core.cfg.num_layers * bs * 2 * core.cfg.num_kv_heads * (core.cfg.head_dim + 4))
    else:
        assert core.kv_wire_dtype == model_dtype
    cache_before = [c if not isinstance(c, dict) else dict(c) for c in core.cache]
    pair.noise(6)
    pair.flush()
    evicted = [h for h in prefix if h in core.host_pool]
    assert evicted, "noise did not push the prefix to the host tier"
    for h in evicted:
        kv = core.host_pool._blocks[h].kv
        if model_dtype == "bfloat16" and kv_dtype == "bf16":
            assert kv.dtype == np.uint16  # numpy has no bfloat16
        assert kv.tobytes() == byte0[h]
    removed = [h for op, _, hs in pair.events["torch"] if op == "removed" for h in hs]
    assert not set(prefix) & set(removed)
    got = pair.run([_wire(PROMPT, "b", 4)])
    s2 = got["torch"][1][0]
    assert core.host_pool.stats.onboards > 0 and s2.num_cached_tokens >= cap * bs
    assert got["torch"][0]["b"] == first["torch"][0]["a"]
    if model_dtype == "float32":
        assert got["jax"][0] == got["torch"][0]
        assert first["jax"][0] == first["torch"][0]
    for h in evicted:
        bid = core.allocator._by_hash[h].block_id
        assert _page(core, bid) == byte0[h], "onboarded page bytes diverged"
        # In place: the tensors the engine held before read the page too.
        for l, c in enumerate(cache_before):
            now = core.cache[l]
            if isinstance(c, dict):
                assert all(now[k] is c[k] for k in c)
            else:
                assert now is c
    stored = [h for op, _, hs in pair.events["torch"] if op == "stored" for h in hs]
    for h in prefix:
        assert stored.count(h) == 1 and removed.count(h) == 0


def test_tier_aware_events_match_jax(weights, tmp_path):
    """With tier callbacks wired, every tier move publishes a tier-tagged
    event on both engines: the same events in the same order."""
    pair = Pair(weights, tier_aware=True, host_kv_blocks=4, disk_kv_blocks=64,
                disk_root=tmp_path, **PRESSURE)
    pair.run([_wire(PROMPT, "a", 4)])
    pair.noise(8, tag=5)
    pair.flush()
    pair.run([_wire(PROMPT, "b", 4)])
    pair.flush()
    tiers = Counter(tier for _, tier, _ in pair.events["torch"])
    assert tiers["host"] > 0 and tiers["disk"] > 0
    assert sorted(pair.events["torch"]) == sorted(pair.events["jax"])
    assert Counter(pair.torch.kv_inventory()) == Counter(pair.jax.kv_inventory())


def test_async_engine_with_tiers_matches_sync(weights):
    """Evictions and onboards with a step in flight: the async engine's
    streams and tier counters are the sync engine's."""
    runs = []
    for async_exec in (False, True):
        pair = Pair(weights, host_kv_blocks=64, async_exec=async_exec, **PRESSURE)
        streams = {}
        for wires in ([_wire(PROMPT, "a", 6)], None, [_wire(PROMPT, "b", 6)]):
            if wires is None:
                pair.noise(6)
                pair.flush()
                continue
            streams.update(pair.run(wires)["torch"][0])
        runs.append((streams, pair.stats("host")[1]))
    assert runs[0] == runs[1]
    assert runs[0][1][1] > 0  # onboards


def test_offload_engine_preserves_bytes_across_tiers(tmp_path):
    """The port's pipeline alone: pages land in host and disk byte for
    byte with their parent links, and fetch() pops them back unchanged."""
    from dynamo_tpu_torch.engine.host_cache import HostKvPool
    from dynamo_tpu_torch.engine.offload import DiskKvPool, OffloadEngine

    host = HostKvPool(2)
    disk = DiskKvPool(tmp_path / "g3", 8)
    eng = OffloadEngine(host, disk)
    rng = np.random.RandomState(0)
    pages = {h: rng.randn(2, 8, 4, 16).astype(np.float32) for h in (101, 102, 103)}
    parent = None
    want_parent = {}
    for h, page in pages.items():
        eng.submit(h, parent, page.copy())
        want_parent[h] = parent
        parent = h
    eng.flush()
    assert len(host) == 2 and len(disk) == 1
    for h, page in pages.items():
        got = eng.fetch(h)
        assert got is not None, f"block {h} lost in the tiers"
        p, kv = got
        assert p == want_parent[h]
        assert np.asarray(kv).tobytes() == page.tobytes()
    eng.close()


def test_disk_put_survives_crash_mid_write(tmp_path, monkeypatch):
    """The port's disk tier writes a tmp file and renames it: a crash mid
    write leaves nothing a later read would onboard."""
    import io

    from dynamo_tpu_torch.engine import offload as offload_mod
    from dynamo_tpu_torch.engine.offload import DiskKvPool

    disk = DiskKvPool(tmp_path / "g3", 8)
    page = np.arange(2 * 8 * 4 * 16, dtype=np.float32).reshape(2, 8, 4, 16)
    real_save = offload_mod.np.save

    def torn_save(f, arr):
        buf = io.BytesIO()
        real_save(buf, arr)
        f.write(buf.getvalue()[: buf.getbuffer().nbytes // 2])
        raise OSError("simulated crash mid-write")

    monkeypatch.setattr(offload_mod.np, "save", torn_save)
    with pytest.raises(OSError):
        disk.put(0xBAD, None, page)
    monkeypatch.setattr(offload_mod.np, "save", real_save)
    assert 0xBAD not in disk
    assert disk.peek(0xBAD) is None and disk.pop(0xBAD) is None
    assert not disk._path(0xBAD).exists()
    assert not list((tmp_path / "g3").glob("*.tmp"))
    disk.put(0xBAD, None, page)
    assert disk.peek(0xBAD).tobytes() == page.tobytes()
    got = disk.pop(0xBAD)
    assert got is not None and got[1].tobytes() == page.tobytes()


def test_offload_does_not_block_step(weights):
    """Evictions enqueue their copies and return: with the offload worker
    stalled on a page, steps that evict still finish."""
    pair = Pair(weights, host_kv_blocks=64, **PRESSURE)
    core = pair.torch
    gate = threading.Event()

    class SlowPage:
        def __array__(self, dtype=None, copy=None):
            gate.wait(timeout=30)
            return np.zeros(1, dtype=np.float32)

    core.offload.submit(-1, None, SlowPage())
    t0 = time.monotonic()
    rng = np.random.RandomState(77)
    for i in range(16):
        core.add_request(PreprocessedRequest.from_wire(
            _wire([int(t) for t in rng.randint(1, 300, size=40)], f"n{i}", 4)))
    while core.has_work():
        core.step()
    elapsed = time.monotonic() - t0
    assert core.offload._q.qsize() > 0, "evictions did not queue behind the stalled page"
    gate.set()
    core.offload.flush()
    assert core.host_pool.stats.offloads > 0
    assert elapsed < 25, f"steps stalled behind offload transfers ({elapsed:.1f}s)"

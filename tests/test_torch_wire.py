"""The worker's wire against the JAX package's: for the same values, the
port packs every control-plane and data-plane message to the same bytes,
and each side reads what the other wrote. The engine's output chunks and
its KV event hashes are plain Python values that pack as the JAX
engine's do."""

import asyncio

import jax
import msgpack
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.backends.jax.main import _model_card as j_model_card
from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import TpuEngine
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.llm import discovery as j_discovery
from dynamo_tpu.llm import model_card as j_card
from dynamo_tpu.llm.kv_router import protocols as j_proto
from dynamo_tpu.runtime import component as j_component
from dynamo_tpu.runtime import framing as j_framing
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.backends.torch.main import _model_card, build_engine
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.llm import discovery as t_discovery
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.llm.kv_router import protocols as t_proto
from dynamo_tpu_torch.runtime import component as t_component
from dynamo_tpu_torch.runtime import framing as t_framing
from dynamo_tpu_torch.runtime.engine import Context

U64 = st.integers(0, 2**64 - 1)
I64 = st.integers(-(2**63), 2**63 - 1)
NAMES = st.text(min_size=1, max_size=12)
SCALARS = st.none() | st.booleans() | I64 | st.floats(allow_nan=False) | NAMES | st.binary(max_size=8)
VALUES = st.recursive(
    SCALARS,
    lambda inner: st.lists(inner, max_size=4) | st.dictionaries(NAMES, inner, max_size=4),
    max_leaves=12,
)


@settings(max_examples=60, deadline=None)
@given(ns=NAMES, comp=NAMES, ep=NAMES, iid=U64, addr=NAMES,
       meta=st.none() | st.dictionaries(NAMES, VALUES, max_size=3))
def test_instance_wire(ns, comp, ep, iid, addr, meta):
    t = t_component.Instance(ns, comp, ep, iid, addr, meta)
    j = j_component.Instance(ns, comp, ep, iid, addr, meta)
    assert t.to_wire() == j.to_wire()
    assert j_component.Instance.from_wire(t.to_wire()) == j
    assert t_component.Instance.from_wire(j.to_wire()) == t


@settings(max_examples=60, deadline=None)
@given(name=NAMES, iid=U64, ctx=st.integers(1, 2**20), bs=st.integers(1, 256),
       blocks=st.none() | st.integers(0, 2**31), seqs=st.none() | st.integers(0, 4096))
def test_model_card_and_entry_wire(name, iid, ctx, bs, blocks, seqs):
    t_mdc = t_card.ModelDeploymentCard(
        name=name, context_length=ctx, kv_block_size=bs,
        runtime_config=t_card.ModelRuntimeConfig(total_kv_blocks=blocks, max_num_seqs=seqs),
    )
    j_mdc = j_card.ModelDeploymentCard(
        name=name, context_length=ctx, kv_block_size=bs,
        runtime_config=j_card.ModelRuntimeConfig(total_kv_blocks=blocks, max_num_seqs=seqs),
    )
    assert t_mdc.to_wire() == j_mdc.to_wire()
    assert t_mdc.checksum() == j_mdc.checksum()
    assert j_card.ModelDeploymentCard.from_wire(t_mdc.to_wire()) == j_mdc
    args = (name, "dynamo", "backend", "generate", iid, t_mdc.checksum())
    assert t_discovery.ModelEntry(*args).to_wire() == j_discovery.ModelEntry(*args).to_wire()


@settings(max_examples=80, deadline=None)
@given(worker=U64, event_id=U64, op=st.sampled_from(["stored", "removed", "cleared"]),
       hashes=st.lists(U64, max_size=8), parent=st.none() | U64,
       tier=st.sampled_from(["device", "host", "disk"]))
def test_router_event_wire(worker, event_id, op, hashes, parent, tier):
    t = t_proto.RouterEvent(worker, event_id, t_proto.KvCacheEvent(op, tuple(hashes), parent, tier))
    j = j_proto.RouterEvent(worker, event_id, j_proto.KvCacheEvent(op, tuple(hashes), parent, tier))
    assert t.to_wire() == j.to_wire()
    assert j_proto.RouterEvent.from_wire(t.to_wire()) == j


@settings(max_examples=60, deadline=None)
@given(worker=U64, ints=st.lists(st.integers(0, 2**31), min_size=7, max_size=7),
       floats=st.lists(st.floats(0, 1), min_size=3, max_size=3),
       transfer=st.none() | st.dictionaries(NAMES, st.integers(0, 2**40), max_size=4),
       net=st.none() | st.dictionaries(U64, st.dictionaries(NAMES, st.integers(0, 99), max_size=3),
                                       min_size=1, max_size=3))
def test_forward_pass_metrics_wire(worker, ints, floats, transfer, net):
    def build(mod):
        return mod.ForwardPassMetrics(
            worker_id=worker,
            worker=mod.WorkerStats(*ints[:5], budget_utilization=floats[0]),
            kv=mod.KvStats(ints[5], ints[6], floats[1], floats[2]),
            transfer=transfer,
            net=net,
        )

    t, j = build(t_proto), build(j_proto)
    assert t.to_wire() == j.to_wire()
    assert j_proto.ForwardPassMetrics.from_wire(t.to_wire()) == j
    assert t_proto.ForwardPassMetrics.from_wire(j.to_wire()) == t


@settings(max_examples=60, deadline=None)
@given(msg=st.dictionaries(NAMES, VALUES, max_size=5))
def test_frames(msg):
    assert t_framing.pack(msg) == j_framing.pack(msg)


def _same_weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(4), j_tiny_model())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")
    return JaxCore(j_tiny_model(), j_tiny_engine(), params=jparams), tparams


async def _stream(engine, context, prompt, logprobs=None):
    req = {
        "model": "tiny", "token_ids": prompt, "request_id": "wire",
        "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 11},
        "output": {"logprobs": logprobs},
    }
    return [out async for out in engine.generate(req, context)]


def _floats_apart(a, b, path=()):
    """``a`` with every float that is within f32 tolerance of ``b``'s
    replaced by ``b``'s: logprobs are f32 sums, close but not bitwise."""
    if isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), path
        return b
    if isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys():
        return {k: _floats_apart(a[k], b[k], path + (k,)) for k in a}
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [_floats_apart(x, y, path + (i,)) for i, (x, y) in enumerate(zip(a, b))]
    return a


async def _plain_then_logprobs(engine, make_context, prompt):
    """One stream, then the same prompt with logprobs on an empty cache."""
    plain = await _stream(engine, make_context("wire"), prompt)
    engine.core.clear_kv_cache()
    return plain, await _stream(engine, make_context("lp"), prompt, logprobs=2)


def test_engine_output_and_kv_events_pack_like_jax():
    """The chunks the worker puts on the data plane, and the hashes its
    KV events carry, pack to the JAX engine's bytes."""
    jcore, tparams = _same_weights()
    stored: list = []
    core, engine = build_engine(
        "tiny", device="cpu", params=tparams,
        on_stored=lambda hashes, parent: stored.append((list(hashes), parent)),
    )
    jstored: list = []
    jcore.allocator.on_stored = lambda hashes, parent: jstored.append((list(hashes), parent))
    prompt = [int(t) for t in np.random.default_rng(8).integers(1, 384, 21)]
    want, want_lp = asyncio.run(_plain_then_logprobs(TpuEngine(jcore), JaxContext, prompt))
    got, got_lp = asyncio.run(_plain_then_logprobs(engine, Context, prompt))
    assert [msgpack.packb(o) for o in got] == [msgpack.packb(o) for o in want]
    assert stored == jstored and stored
    assert all(type(h) is int for hashes, _ in stored for h in hashes)
    assert msgpack.packb(stored) == msgpack.packb(jstored)
    # With logprobs the chunks pack alike once the f32 values are matched
    # within tolerance.
    assert len(got_lp) == len(want_lp) and "logprobs" in got_lp[0]
    assert [msgpack.packb(_floats_apart(o, w)) for o, w in zip(got_lp, want_lp)] == [
        msgpack.packb(w) for w in want_lp
    ]
    # The card the worker registers is the JAX worker's for the same engine.
    assert _model_card("tiny", "byte", core).to_wire() == j_model_card("tiny", "byte", jcore).to_wire()

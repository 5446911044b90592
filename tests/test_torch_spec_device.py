"""The port's speculative decoding with drafts made on the device, against
the JAX package's, on the tiny preset and the CPU.

With ``spec_device_draft`` a speculating lane drafts between the fused
megastep's iterations: ``device_ngram_draft`` suffix-matches its history
ring (plain tensor code, a replay of ``propose_ngram``), ``verify_tokens``
verifies pending + draft as one width-R row, and ``ring_append`` shifts
the emitted tokens in, all inside ``_megastep_draft_body``. The ring and
the drafter are held against the JAX package's and against
``propose_ngram`` on generated histories and knobs; the drafting body
alone against the JAX body; streams, log-probabilities, stats and dispatch
counts under waves (sync and async, k = 1 and 8, one run per
configuration shared through the module's fixture) against the JAX
engine's and the port's without speculation; and every graph key that
speculating engines dispatch is among those ``warm_up()`` captures.
Chunked scheduling's drafting cases are in
``test_torch_spec_device_chunked.py``.

Tolerances: log-probabilities within 1e-4, cache pages within 1e-5 (f32
on both sides, summed in other orders); everything else exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_spec_harness import (
    DISPATCH_KEYS,
    REPEAT_PROMPT,
    SPEC,
    assert_logprobs_close,
    drive,
    make_core,
    make_weights,
    matrix_runner,
    wire,
)

from dynamo_tpu.engine import core as jcore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import sampler as jsampler
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.spec import propose_ngram as j_propose_ngram
from dynamo_tpu_torch.engine import core as tcore
from dynamo_tpu_torch.engine import sampler as tsampler
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import cache_from_numpy
from dynamo_tpu_torch.spec import propose_ngram

LP_TOL = 1e-4
CACHE_TOL = 1e-5
DEVICE = {**SPEC, "spec_device_draft": True}
MATRIX = [("waves", 1), ("waves", 8)]


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def matrix_runs(weights):
    return matrix_runner(weights, spec_device_draft=True)


# -- the ring and the drafter ------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_ring_append_matches_jax(data):
    """Shifting each lane's ``count`` fresh tokens into its right-aligned
    ring, as the JAX engine does; ``count`` 0 is the identity."""
    S = data.draw(st.integers(1, 6))
    H = data.draw(st.sampled_from([4, 9, 23]))
    E = data.draw(st.integers(1, 6))
    ints = st.integers(-1, 50)
    hist = np.array(data.draw(st.lists(ints, min_size=S * H, max_size=S * H)), np.int32).reshape(S, H)
    lens = np.array(data.draw(st.lists(st.integers(0, H), min_size=S, max_size=S)), np.int32)
    emitted = np.array(data.draw(st.lists(ints, min_size=S * E, max_size=S * E)), np.int32).reshape(S, E)
    count = np.array(data.draw(st.lists(st.integers(0, E), min_size=S, max_size=S)), np.int32)
    args = (hist, lens, emitted, count)
    want = jsampler.ring_append(*map(jnp.asarray, args))
    got = tsampler.ring_append(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[count == 0] == hist[count == 0]).all()


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_device_ngram_draft_replays_propose_ngram(data):
    """Over generated histories, windows, suffix bounds, vocabularies and
    draft caps (several lanes with their own knobs in one call), each
    lane's device draft is exactly ``propose_ngram``'s on the same tail
    (the port's and the JAX package's copy), or nothing; and the whole
    output equals the JAX drafter's."""
    nmax_static = data.draw(st.integers(1, 3))
    window_max = data.draw(st.integers(4, 20))
    H = window_max + nmax_static
    S = data.draw(st.integers(1, 4))
    slots = data.draw(st.integers(1, 5))
    vocab = data.draw(st.sampled_from([2, 3, 5, 50]))
    hist = np.full((S, H), -1, np.int32)
    lens, win, nmin, nmax, kcap, ctxs = [], [], [], [], [], []
    for i in range(S):
        L = data.draw(st.integers(0, H))
        ctx = data.draw(st.lists(st.integers(0, vocab - 1), min_size=L, max_size=L))
        if L:
            hist[i, H - L:] = ctx
        hi = data.draw(st.integers(1, nmax_static))
        lo = data.draw(st.integers(1, hi))
        w = data.draw(st.integers(1, window_max))
        k = data.draw(st.integers(-1, slots))
        lens.append(L), win.append(w), nmin.append(lo), nmax.append(hi), kcap.append(k)
        ctxs.append(ctx)
    args = [hist] + [np.array(a, np.int32) for a in (lens, win, nmin, nmax, kcap)]
    kw = dict(ngram_max_static=nmax_static, slots=slots)
    got = tsampler.device_ngram_draft(*map(torch.from_numpy, args), **kw)
    want = jsampler.device_ngram_draft(*map(jnp.asarray, args), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i, ctx in enumerate(ctxs):
        host = propose_ngram(ctx, kcap[i], nmin[i], nmax[i], win[i])
        assert host == j_propose_ngram(ctx, kcap[i], nmin[i], nmax[i], win[i])
        assert [int(t) for t in got[0][i, : int(got[1][i])]] == host, (ctx, i)


# -- the drafting megastep alone ---------------------------------------------------


def test_draft_body_matches_jax(weights):
    """A device-drafting decode lane, a host-drafted verify row, a chunk
    that completes its prompt and a mid-prompt chunk in one drafting
    megastep of 4 iterations at R = 5, from the same cache: equal tokens,
    per-round counts and log-probabilities, pages within 1e-5; the device
    lane drafted in later rounds."""
    jcfg, jeng, tcfg, teng = j_tiny_model(), j_tiny_engine(), tiny_model(), tiny_engine()
    bs, g, P = teng.block_size, teng.garbage_block, teng.max_blocks_per_seq
    rng = np.random.default_rng(4)
    init = [rng.standard_normal(np.asarray(c).shape).astype(np.float32)
            for c in jmodel.init_cache(jcfg, jeng)]
    jcache = tuple(jnp.asarray(c) for c in init)
    tcache = cache_from_numpy(tuple(init), device="cpu")
    R, S, T, n_steps, H = 5, 4, 32, 4, 12
    # lane: (tokens, first position, kv length, blocks, n_sample)
    lanes = [
        ([17], 12, 13, [1, 2, 3, 10], 1),             # drafts on the device
        ([40, 41, 42], 5, 8, [4, 5, 11], 3),          # verify row, a 2-token host draft
        (list(range(50, 60)), 0, 10, [6, 7, 12], 1),  # chunk completing a 10-token prompt
        (list(range(70, 78)), 0, 8, [8, 9], 1),       # first chunk of a longer prompt
    ]
    tokens, positions = np.zeros(T, np.int32), np.zeros(T, np.int32)
    write_pages, write_offs = np.full(T, g, np.int32), np.zeros(T, np.int32)
    kv_lens, tables = np.zeros(S, np.int32), np.full((S, P), g, np.int32)
    cu, gather, counters = np.zeros(S + 1, np.int32), np.zeros((S, R), np.int32), np.zeros((S, R), np.int32)
    gen0 = np.array([7, 2, 0, 0], np.int32)
    t = 0
    for i, (toks, p0, kv, blocks, n) in enumerate(lanes):
        m = len(toks)
        pos = np.arange(p0, p0 + m)
        tokens[t : t + m], positions[t : t + m] = toks, pos
        write_pages[t : t + m] = np.asarray(blocks)[pos // bs]
        write_offs[t : t + m] = pos % bs
        kv_lens[i], tables[i, : len(blocks)] = kv, blocks
        off = np.minimum(np.arange(R), m - 1) if n > 1 else np.full(R, m - 1)
        gather[i], counters[i] = t + off, gen0[i] + (off if n > 1 else 0)
        t += m
        cu[i + 1] = t
    seeds = np.array([3, 4, 5, 6], np.int32)
    temp = np.array([0.0, 0.8, 0.9, 0.7], np.float32)
    top_k, top_p = np.zeros(S, np.int32), np.ones(S, np.float32)
    rep = lambda a: np.repeat(a, R)  # noqa: E731
    draft = np.full((S, R - 1), -1, np.int32)
    draft[1, :2] = [41, 42]
    draft_len = np.array([0, 2, 0, 0], np.int32)
    cont = np.array([True, True, True, False])
    base_pos = np.array([13, 6, 10, 0], np.int32)
    watch = np.full((S, 8), -1, np.int32)
    budgets = np.array([30, 30, 30, n_steps * R + 1], np.int32)
    min_left = np.zeros(S, np.int32)
    hist = np.zeros((S, H), np.int32)
    hist[0] = [9, 17, 3, 5, 9, 17, 3, 5, 9, 17, 3, 5]
    hist_len = np.array([12, 0, 0, 0], np.int32)
    dd = np.array([True, False, False, False])
    win, nmin, nmax, kmax = (np.full(S, v, np.int32) for v in (9, 1, 3, 4))
    ragged = [tokens, positions, write_pages, write_offs, kv_lens, tables, cu,
              np.array([S], np.int32), gather.reshape(-1), rep(seeds), counters.reshape(-1),
              rep(temp), rep(top_k), rep(top_p)]
    rest = [draft, draft_len, cont, base_pos, seeds, temp, top_k, top_p, watch, budgets,
            min_left, hist, hist_len, dd, win, nmin, nmax, kmax]
    kw = dict(n_steps=n_steps, need_mask=False, all_greedy=False, want_logprobs=True,
              ngram_max_static=3)

    def jax_body(cache):
        return jcore._megastep_draft_body(
            weights[0], cache, *map(jnp.asarray, ragged),
            jnp.zeros((1, 1), jnp.float32), jnp.zeros(1, bool),
            *map(jnp.asarray, rest), want_mm=False, cfg=jcfg, engine=jeng, **kw,
        )

    # The device lane's ring quotes the token its iteration 0 samples
    # (greedy, whatever the ring holds), so its next round finds a match.
    t0 = int(jax_body(jcache)[0][0, 0, 0])
    hist[0] = [9, 17, 3, 5, t0, 21, 22, 23, 24, 9, 17, 3]
    want, want_aux, want_lps, jcache = jax_body(tuple(jnp.asarray(c) for c in init))
    got, got_aux, got_lps = tcore._megastep_draft_body(
        weights[1], tcache, *map(torch.from_numpy, ragged), *map(torch.from_numpy, rest),
        cfg=tcfg, engine=teng, **kw,
    )
    assert got.shape == (n_steps, S, R) and got_aux.shape == (3, n_steps, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_aux.numpy(), np.asarray(want_aux))
    np.testing.assert_allclose(got_lps[0].numpy(), np.asarray(want_lps[0]), atol=LP_TOL)
    np.testing.assert_array_equal(got_lps[1].numpy(), np.asarray(want_lps[1]))
    for jc, tc in zip(jcache, tcache):
        np.testing.assert_allclose(tc.numpy()[:g], np.asarray(jc)[:g], atol=CACHE_TOL)
    assert got_aux[1, 1:, 0].sum() > 0  # the device lane drafted in later rounds


# -- stream parity over the matrix ---------------------------------------------------


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_device_streams_match_jax(matrix_runs, scheduling, k):
    """Device-drafted streams (tokens, finish reasons, log-probabilities)
    equal the JAX engine's, sync and async."""
    runs = matrix_runs(scheduling, k)
    want = runs["jax", False][0]
    for key in (("jax", True), ("torch", False), ("torch", True)):
        got = runs[key][0]
        assert got[:2] == want[:2], key
        assert_logprobs_close(got[2], want[2])


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_device_stats_and_dispatches_match_jax(matrix_runs, scheduling, k):
    """``spec_decode_stats()`` (device rounds and hits among them) and the
    dispatch counts equal the JAX engine's, sync and async; at k = 8 the
    lanes drafted on the device."""
    runs = matrix_runs(scheduling, k)
    for async_exec in (False, True):
        jc, tc = runs["jax", async_exec][1], runs["torch", async_exec][1]
        assert tc.spec_decode_stats() == jc.spec_decode_stats()
        jst, tst = jc.scheduler_stats(), tc.scheduler_stats()
        assert {k2: tst[k2] for k2 in DISPATCH_KEYS} == {k2: jst[k2] for k2 in DISPATCH_KEYS}
    st_ = runs["torch", False][1].spec_decode_stats()
    assert (st_["device_rounds"] > 0 and st_["device_hits"] > 0) == (k > 1)


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_device_spec_on_equals_spec_off(matrix_runs, scheduling, k):
    runs = matrix_runs(scheduling, k)
    off, on = runs["torch_off"][0], runs["torch", False][0]
    assert on[:2] == off[:2]
    assert_logprobs_close(on[2], off[2])


def test_async_rings_gather_the_in_flight_tail(weights):
    """Under async execution a drafting lane's ring takes the in-flight
    step's tokens from the device (its newest slots), and the drafts it
    makes are the JAX engine's: the stats equal JAX's async run."""
    core = make_core("torch", weights, **DEVICE, megastep_k=8, async_exec=True)
    fed = []
    inner = core._pack_rings
    core._pack_rings = lambda *a: fed.append(inner(*a)) or fed[-1]
    wires = [wire(REPEAT_PROMPT, "rep", 40, ignore_eos=True),
             wire([7, 8] * 6, "tmp", 40, temperature=0.8, seed=21, ignore_eos=True)]
    got = drive(core, wires)[:2]
    jc = make_core("jax", weights, **DEVICE, megastep_k=8, async_exec=True)
    assert got == drive(jc, wires)[:2]
    assert any(fed)
    assert core.spec_decode_stats() == jc.spec_decode_stats()


def test_device_draft_amortizes_dispatches(weights):
    """At equal spec_k the device drafter runs several draft, verify and
    accept rounds per dispatch: fewer dispatches per accepted token than
    host drafting, as in the JAX engine."""
    wires = [wire(REPEAT_PROMPT, "rep", 24, ignore_eos=True)]
    stats = {}
    for pkg in ("jax", "torch"):
        for name, eng in (("host", SPEC), ("device", DEVICE)):
            core = make_core(pkg, weights, **eng, megastep_k=8)
            drive(core, wires)
            stats[pkg, name] = core.spec_decode_stats()
    assert stats["torch", "host"] == stats["jax", "host"]
    assert stats["torch", "device"] == stats["jax", "device"]
    sd, sh = stats["torch", "device"], stats["torch", "host"]
    assert sd["device_rounds"] > 0
    assert sd["dispatches_per_accepted_token"] < sh["dispatches_per_accepted_token"]


# -- graph keys -----------------------------------------------------------------------


@pytest.mark.parametrize("scheduling", ["waves", "chunked"])
@pytest.mark.parametrize("drafter", ["host", "device"])
def test_warm_up_enumerates_every_speculating_key(weights, scheduling, drafter):
    """Every graph key that a speculating engine dispatches (verify and
    fused keys at sample width spec_k + 1 and 1, drafting megasteps, under
    waves and chunked scheduling, sync and async, every sampling variant)
    is one that ``warm_up()`` captures on the card."""
    eng = {**(DEVICE if drafter == "device" else SPEC), "max_model_len": 64, "megastep_k": 8}
    if scheduling == "chunked":
        eng.update(scheduling="chunked", prefill_chunk=32)
    seen, warm = set(), None
    for async_exec in (False, True):
        core = make_core("torch", weights, **eng, async_exec=async_exec)
        warm = {launch.key for launch, _ in core._warm_up_launches()}
        inner = core._launch
        core._launch = lambda launch, feed=None, inner=inner: seen.add(launch.key) or inner(launch, feed)
        rng = np.random.RandomState(4)
        wires = [
            wire(REPEAT_PROMPT[:20], "rep", None, ignore_eos=True),
            wire(list(rng.randint(1, 200, size=50)), "wide", 4),
            wire([3, 5, 7] * 3, "g_lp", 11, logprobs=2),
            wire([4, 6] * 4, "t", 6, temperature=0.8, seed=1),
            wire([4, 6, 9] * 3, "t_lp", 5, temperature=0.8, seed=2, logprobs=1),
            wire([2, 8] * 4, "m", 9, temperature=0.7, seed=3, top_k=5),
            wire([2, 8, 1] * 3, "m_lp", 13, temperature=0.7, seed=4, top_p=0.5, logprobs=1),
        ]
        drive(core, wires)
        for w in wires:
            drive(core, [{**w, "request_id": w["request_id"] + "_solo"}])
    assert seen <= warm, sorted(seen - warm)
    R = core._spec_R
    assert any(key[0] == "fused" and key[4] == R for key in seen)
    assert any(key[0] == "drafted" for key in seen) == (drafter == "device")
    assert any(key[0] == "drafted" for key in warm) == (drafter == "device")

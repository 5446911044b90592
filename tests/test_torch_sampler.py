"""The port's sampler against the JAX package's.

Greedy choices, stop flags and logprob alternatives match exactly
(logprob values at 1e-5: f32 logsumexp in a different order). Seeded
draws use the port's own counter-based noise, so they are held to their
contract instead: a lane's draw depends on its (seed, counter) alone, and
the draws follow the softmax distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampler as jsampler
from dynamo_tpu_torch.engine import sampler as tsampler

V = 384


def _logits(seed, B=6, v=V):
    return np.random.default_rng(seed).standard_normal((B, v)).astype(np.float32) * 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_matches_jax(seed):
    logits = _logits(seed)
    B = logits.shape[0]
    temp = np.zeros(B, np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    want = np.asarray(
        jsampler.sample(
            jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temp),
            jnp.asarray(top_k), jnp.asarray(top_p), need_mask=False, all_greedy=True,
        )
    )
    t = torch.from_numpy
    got = tsampler.sample_seeded(
        t(logits), t(np.arange(B, dtype=np.int32)), t(np.zeros(B, np.int32)),
        t(temp), t(top_k), t(top_p), all_greedy=True,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    # temperature-0 lanes inside a sampled batch take the same greedy ids.
    temp_mixed = np.where(np.arange(B) % 2 == 0, 0.0, 0.8).astype(np.float32)
    mixed = tsampler.sample_seeded(
        t(logits), t(np.arange(B, dtype=np.int32)), t(np.zeros(B, np.int32)),
        t(temp_mixed), t(top_k), t(top_p), need_mask=False,
    )
    np.testing.assert_array_equal(mixed.numpy()[::2], want[::2])


def test_stop_flags_match_jax():
    rng = np.random.default_rng(5)
    B, W = 16, 8
    sampled = rng.integers(0, 6, B).astype(np.int32)
    watch = np.where(rng.random((B, W)) < 0.3, rng.integers(0, 6, (B, W)), -1).astype(np.int32)
    budgets = rng.integers(1, 5, B).astype(np.int32)
    min_left = rng.integers(0, 4, B).astype(np.int32)
    for i in range(4):
        want = np.asarray(
            jsampler.stop_flags(*map(jnp.asarray, (sampled, watch, budgets, min_left)), i)
        )
        got = tsampler.stop_flags(*map(torch.from_numpy, (sampled, watch, budgets, min_left)), i)
        np.testing.assert_array_equal(got.numpy(), want)


def test_token_logprobs_match_jax():
    logits = _logits(9)
    tokens = np.array([0, 5, 383, 17, 2, 99], np.int32)
    want = jsampler.token_logprobs(jnp.asarray(logits), jnp.asarray(tokens))
    got = tsampler.token_logprobs(torch.from_numpy(logits), torch.from_numpy(tokens))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5, rtol=1e-5)
    assert got[1].shape == (6, jsampler.LOGPROBS_K) and tsampler.LOGPROBS_K == jsampler.LOGPROBS_K


def _jax_top_mask(scaled, top_k, top_p, cap):
    """The capped candidate mask exactly as dynamo_tpu/engine/sampler.py
    builds it inside ``sample`` (lines 295-303)."""
    vals, idx = jax.lax.top_k(scaled, cap)
    ranks = jnp.arange(cap, dtype=jnp.int32)[None, :]
    k = jnp.where(top_k > 0, jnp.minimum(top_k, cap), cap)[:, None]
    probs = jax.nn.softmax(vals, axis=-1)
    cum_prev = jnp.cumsum(probs, axis=-1) - probs
    keep_p = cum_prev < jnp.where(top_p >= 1.0, 2.0, top_p)[:, None]
    return vals, idx, (ranks < k) & keep_p


def test_top_k_top_p_mask_matches_jax():
    logits = _logits(3)
    top_k = np.array([0, 1, 5, 64, 100, 3], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 0.3, 1.0, 0.05], np.float32)
    jv, ji, jkeep = _jax_top_mask(jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p), 64)
    tv, ti, tkeep = tsampler.top_candidates(
        torch.from_numpy(logits), torch.from_numpy(top_k), torch.from_numpy(top_p), 64
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    # Masked sampling only ever returns kept candidates.
    B = logits.shape[0]
    for counter in range(20):
        got = tsampler.sample_seeded(
            torch.from_numpy(logits), torch.arange(B), torch.full((B,), counter),
            torch.ones(B), torch.from_numpy(top_k), torch.from_numpy(top_p),
        ).numpy()
        for b in range(B):
            if top_k[b] > 0 or top_p[b] < 1.0:
                assert got[b] in ti.numpy()[b][tkeep.numpy()[b]]


def test_seeded_draw_depends_only_on_seed_and_counter():
    logits = _logits(4, B=5)
    seeds = torch.tensor([11, 12, 13, 14, 15])
    counters = torch.tensor([0, 7, 3, 3, 1])
    temp = torch.full((5,), 1.5)
    top_k, top_p = torch.zeros(5, dtype=torch.int32), torch.ones(5)
    batch = tsampler.sample_seeded(
        torch.from_numpy(logits), seeds, counters, temp, top_k, top_p, need_mask=False
    )
    for b in range(5):
        alone = tsampler.sample_seeded(
            torch.from_numpy(logits[b : b + 1]), seeds[b : b + 1], counters[b : b + 1],
            temp[b : b + 1], top_k[b : b + 1], top_p[b : b + 1], need_mask=False,
        )
        assert int(alone[0]) == int(batch[b])
    key = torch.stack([seeds, counters], 1)
    np.testing.assert_array_equal(
        tsampler.gumbel_noise(key, V).numpy(), tsampler.gumbel_noise(key, V).numpy()
    )
    other = key.clone()
    other[:, 1] += 1
    assert (tsampler.gumbel_noise(key, V) != tsampler.gumbel_noise(other, V)).float().mean() > 0.99


def test_seeded_draws_follow_softmax():
    logits = np.array([[2.0, 1.0, 0.0, -1.0]], np.float32)
    n = 6000
    key = torch.stack([torch.full((n,), 5), torch.arange(n)], 1)
    draws = torch.argmax(
        torch.from_numpy(logits).expand(n, 4) + tsampler.gumbel_noise(key, 4), dim=-1
    )
    freq = np.bincount(draws.numpy(), minlength=4) / n
    probs = np.exp(logits[0]) / np.exp(logits[0]).sum()
    np.testing.assert_allclose(freq, probs, atol=0.025)

"""Batched token sampling on the device: greedy / temperature / top-k / top-p.

Counterpart of ``dynamo_tpu/engine/sampler.py``. Per-request sampling
params arrive as tensors (one lane per sequence), so one code path serves
any mix of greedy and sampled requests with no host round trip per token.

Masking works on a ``k_cap``-sized ``topk`` slice instead of a full-vocab
sort: top-k is exact for k <= k_cap and the nucleus is computed within
those candidates, exactly as the JAX sampler does.

Seeded draws. JAX keys each lane with ``fold_in(fold_in(PRNGKey(0), seed),
counter)`` and draws through threefry; the port does not reproduce those
bits. Each lane's key is its ``(seed, counter)`` pair, and its Gumbel noise
comes from a counter-based integer hash of ``(seed, counter, vocab index)``
computed with integer tensor ops on the device. A lane's draw therefore
depends on its own seed and counter only — never on its batch neighbours,
the scheduler or the megastep length — which is the property the engine
relies on. Greedy streams are the parity gate with the JAX package.
"""

from __future__ import annotations

import torch

DEFAULT_TOP_CAP = 64

# Top-k alternatives returned when a request asks for logprobs (the OpenAI
# maxima: completions k <= 5, chat top_logprobs <= 20).
LOGPROBS_K = 20

_M32 = 0xFFFFFFFF


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32
    values. Products are masked back to 32 bits, so the int64 wrap of a
    large product never reaches the result."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def gumbel_noise(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise ``[B, n]`` f32 for per-lane keys ``key``
    ``[B, 2]`` (seed, counter): entry ``(b, j)`` is a pure function of
    ``(seed_b, counter_b, j)``."""
    k = key.to(torch.int64) & _M32
    lane = _fmix32((_fmix32(k[:, 0] ^ 0x9E3779B9) + k[:, 1] * 0x85EBCA77) & _M32)
    idx = _fmix32(torch.arange(n, dtype=torch.int64, device=key.device) + 0x7F4A7C15)
    bits = _fmix32(lane[:, None] ^ idx[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_seeded(
    logits: torch.Tensor,       # [B, V] float32
    seeds: torch.Tensor,        # [B] int — per-lane request seeds
    counters: torch.Tensor,     # [B] int — per-lane position counters
    temperature: torch.Tensor,  # [B] float32; 0 => greedy
    top_k: torch.Tensor,        # [B] int
    top_p: torch.Tensor,        # [B] float32
    *,
    need_mask: bool = True,
    all_greedy: bool = False,
) -> torch.Tensor:              # [B] int32
    """The seeded-sampling entry of the prefill wave and the decode
    megastep: lane ``b`` draws with key ``(seeds[b], counters[b])``, so any
    path that samples position ``counter`` of request ``seed`` draws the
    same token — which is why megastep output at k=8 matches k=1."""
    if all_greedy:
        return sample(
            logits, None, temperature, top_k, top_p,
            need_mask=False, all_greedy=True,
        )
    key = torch.stack([seeds.to(torch.int64), counters.to(torch.int64)], dim=1)
    return sample(logits, key, temperature, top_k, top_p, need_mask=need_mask)


def stop_flags(
    sampled: torch.Tensor,   # [B] int32 — tokens just sampled at inner step i
    watch: torch.Tensor,     # [B, W] int32 — per-lane stop ids, -1 padded
    budgets: torch.Tensor,   # [B] int32 — remaining max-tokens budget
    min_left: torch.Tensor,  # [B] int32 — tokens until min_tokens is met
    i: int,                  # 0-based inner iteration
) -> torch.Tensor:           # [B] bool — True where the lane stops HERE
    """On-device per-lane stop detection for the decode megastep. The host
    stop-scan stays the authority: flags may under-stop, never over-stop."""
    gen = i + 1
    watch_hit = (sampled[:, None] == watch).any(dim=1) & (gen >= min_left)
    budget_hit = gen >= budgets
    return watch_hit | budget_hit


def token_logprobs(
    logits: torch.Tensor,  # [B, V] float32 (raw, pre-temperature)
    tokens: torch.Tensor,  # [B] int — the chosen tokens
    k: int = LOGPROBS_K,
):
    """Chosen-token logprob plus top-k alternatives under the model's raw
    distribution. Returns (chosen [B], top_ids [B, k] i32, top_lps [B, k])."""
    lp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    chosen = torch.gather(lp, 1, tokens.to(torch.int64)[:, None])[:, 0]
    top_lps, top_ids = torch.topk(lp, k, dim=-1)
    return chosen, top_ids.to(torch.int32), top_lps


def top_candidates(
    scaled: torch.Tensor,  # [B, V] temperature-scaled logits
    top_k: torch.Tensor,   # [B] int; <= 0 => disabled
    top_p: torch.Tensor,   # [B] float32; >= 1 => disabled
    cap: int,
):
    """The capped candidate set: (values [B, cap] descending, their vocab
    ids, keep mask). Ranks below top-k whose preceding cumulative mass is
    under top-p are kept; rank 0 always is."""
    vals, idx = torch.topk(scaled, cap, dim=-1)
    ranks = torch.arange(cap, device=scaled.device)[None, :]
    k = torch.where(top_k > 0, torch.clamp(top_k, max=cap), cap)[:, None]
    keep_k = ranks < k
    probs = torch.softmax(vals, dim=-1)
    cum_prev = torch.cumsum(probs, dim=-1) - probs
    keep_p = cum_prev < torch.where(top_p >= 1.0, 2.0, top_p)[:, None]
    return vals, idx, keep_k & keep_p


def sample(
    logits: torch.Tensor,        # [B, V] float32
    key: torch.Tensor | None,    # [B, 2] per-lane (seed, counter) keys
    temperature: torch.Tensor,   # [B] float32; 0 => greedy
    top_k: torch.Tensor,         # [B] int; <= 0 => disabled
    top_p: torch.Tensor,         # [B] float32; >= 1 => disabled
    *,
    need_mask: bool = True,      # False skips top-k/top-p entirely
    all_greedy: bool = False,    # every lane has temperature == 0
    k_cap: int = DEFAULT_TOP_CAP,
) -> torch.Tensor:               # [B] int32
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    noise = gumbel_noise(key, V)

    def draw(values: torch.Tensor) -> torch.Tensor:
        # Gumbel-max: argmax(values + g) is a categorical draw.
        return torch.argmax(values + noise[:, : values.shape[1]], dim=-1)

    if not need_mask:
        return torch.where(temperature <= 0.0, greedy, draw(scaled).to(torch.int32))

    vals, idx, keep = top_candidates(scaled, top_k, top_p, min(k_cap, V))
    choice = draw(torch.where(keep, vals, -torch.inf))
    sampled_masked = torch.gather(idx, 1, choice[:, None])[:, 0]
    # Pure-temperature lanes in a masked batch keep full-vocab sampling;
    # only lanes that asked for top-k/top-p get the capped candidate set.
    sampled_full = draw(scaled)
    lane_masked = (top_k > 0) | (top_p < 1.0)
    sampled = torch.where(lane_masked, sampled_masked, sampled_full).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)

"""Batched token sampling on the device: greedy / temperature / top-k / top-p.

Counterpart of ``dynamo_tpu/engine/sampler.py``. Per-request sampling
params arrive as tensors (one lane per sequence), so one code path serves
any mix of greedy and sampled requests with no host round trip per token.

Masking works on a ``k_cap``-sized ``topk`` slice instead of a full-vocab
sort: top-k is exact for k <= k_cap and the nucleus is computed within
those candidates, exactly as the JAX sampler does.

Seeded draws reproduce JAX's bits. Each lane's key is
``fold_in(fold_in(PRNGKey(0), seed), counter)`` and its noise is
``jax.random.gumbel(key, (V,))`` as ``jax.random.categorical`` draws it:
threefry2x32, ``fold_in``, the partitionable 32-bit random bits (element
``j`` is threefry of the counter pair ``(0, j)``, so it depends on ``j``
alone and a ``[:cap]`` slice is the draw of shape ``(cap,)``), the mantissa
trick of ``_uniform`` and ``-log(-log(u))``. All of it is int64 tensor
arithmetic masked to 32 bits, the same on the CPU and the card. The
random bits and uniforms are bit-identical to JAX's; the Gumbel values
can differ from XLA's in the last bit of ``log``, so a sampled token can
differ only where two candidates tie to that precision. A lane's draw
depends on its own seed and counter only, never on its batch neighbours,
the scheduler or the megastep length.
"""

from __future__ import annotations

import torch

DEFAULT_TOP_CAP = 64

# Top-k alternatives returned when a request asks for logprobs (the OpenAI
# maxima: completions k <= 5, chat top_logprobs <= 20).
LOGPROBS_K = 20

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of ``jax._src.prng``, on int64
    tensors holding uint32 values; operands broadcast. Every sum is masked
    back to 32 bits, so the int64 never wraps."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl32(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for per-lane keys ``[B, 2]`` and data ``[B]``:
    threefry of the counter pair ``(0, data)``."""
    k = key.to(torch.int64) & _M32
    d = data.to(torch.int64) & _M32
    y1, y2 = threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32, partitionable threefry) for
    each lane of ``key`` ``[B, 2]``: ``[B, n]`` int64 holding uint32."""
    k = key.to(torch.int64) & _M32
    j = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    b1, b2 = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(j), j)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key_b, (n,), minval=tiny, maxval=1)`` (f32) for
    each lane of ``key`` ``[B, 2]``, as ``jax._src.random._uniform`` builds
    it: 23 random mantissa bits OR'd into 1.0, minus 1, scaled to
    ``[tiny, 1)`` and clamped at ``tiny``. Bit-identical to JAX's."""
    mant = (random_bits(key, n) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # Python scalars, not a tensor made here: a host-to-device copy cannot
    # sit inside a captured CUDA graph. ``1 - tiny`` is 1.0 in f32 and in
    # f64 alike, and ``tiny`` is an f32 value, so the arithmetic is the
    # f32 arithmetic of JAX's, bit for bit.
    return torch.clamp(floats * (1.0 - _F32_TINY) + _F32_TINY, min=_F32_TINY)


def gumbel_noise(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key_b, (n,))`` (f32, mode "low"):
    ``-log(-log(u))`` of :func:`uniform`, ``[B, n]``."""
    return -torch.log(-torch.log(uniform(key, n)))


def lane_keys(seeds: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Per-lane keys ``fold_in(fold_in(PRNGKey(0), seed), counter)``
    ``[B, 2]``, as the JAX sampler builds them."""
    base = torch.zeros((seeds.shape[0], 2), dtype=torch.int64, device=seeds.device)
    return fold_in(fold_in(base, seeds), counters)


def gather_feedback(
    prev_tokens: torch.Tensor,  # previous dispatch's sampled tokens, any shape
    host_tokens: torch.Tensor,  # [T] int32 — host-assembled token buffer
    src_idx: torch.Tensor,      # [T] int32 — flat index into prev_tokens, or -1
) -> torch.Tensor:              # [T] int32
    """Device-resident token feedback (async execution): slots of the next
    step's token buffer whose value is a just-sampled token read it
    straight from the previous dispatch's device output, so the sampled id
    never makes a device-to-host-to-device round trip on the critical
    path. Slots with ``src_idx < 0`` keep the host value. A gather and a
    select on the current stream; the host never waits on it."""
    flat = prev_tokens.reshape(-1)
    fed = flat[torch.clamp(src_idx, 0, flat.shape[0] - 1).long()]
    return torch.where(src_idx >= 0, fed, host_tokens)


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
    megastep: lane ``b`` draws with JAX's key ``fold_in(fold_in(PRNGKey(0),
    seeds[b]), counters[b])``, so any path that samples position
    ``counter`` of request ``seed`` draws the same token — which is why
    megastep output at k=8 matches k=1."""
    if all_greedy:
        return sample(
            logits, None, temperature, top_k, top_p,
            need_mask=False, all_greedy=True,
        )
    return sample(
        logits, lane_keys(seeds, counters), temperature, top_k, top_p,
        need_mask=need_mask,
    )


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


def resolve_verify(
    sampled: torch.Tensor,    # [S, R] int32 — the target's choice per verify slot
    draft: torch.Tensor,      # [S, R-1] int32 — drafted tokens, -1 padded
    draft_len: torch.Tensor,  # [S] int32 — live draft length (0 = plain row)
) -> tuple[torch.Tensor, torch.Tensor]:  # (accepted [S], next_token [S])
    """Accept/reject on the device for the fused megastep's first
    iteration: ``accepted`` is the longest drafted prefix the target agrees
    with (slot j of ``sampled`` is its ``(seed, counter + j)`` choice after
    the row's j-th token), ``next_token`` the target's choice at slot
    ``accepted``, which the lane continues decoding from. Rows that drafted
    nothing (decode rows, prefill chunks) resolve to ``(0, sampled[:, 0])``,
    which is all of it at R = 1."""
    R = sampled.shape[1]
    if R == 1:
        return torch.zeros_like(sampled[:, 0]), sampled[:, 0]
    j = torch.arange(R - 1, dtype=torch.int32, device=sampled.device)[None, :]
    match = (sampled[:, :-1] == draft) & (j < draft_len[:, None])
    acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    nxt = torch.gather(sampled, 1, acc.long()[:, None])[:, 0]
    return acc, nxt


def stop_flags_prefix(
    sampled: torch.Tensor,   # [S, R] int32 — the first iteration's sampled slots
    accepted: torch.Tensor,  # [S] int32 — emitted slots are 0..accepted
    watch: torch.Tensor,     # [S, W] int32 — per-lane stop ids, -1 padded
    budgets: torch.Tensor,   # [S] int32 — remaining max-tokens budget
    min_left: torch.Tensor,  # [S] int32 — tokens until min_tokens is met
    gen_base: torch.Tensor | None = None,  # [S] int32 — tokens this dispatch
                             # emitted before these slots (default 0)
) -> torch.Tensor:           # [S] bool — True where the lane stops HERE
    """Stop flags over a fused iteration whose emission count depends on
    the data: slot j (the dispatch's token ``gen_base + j + 1``) stops the
    lane when it is emitted (``j <= accepted``) and is a watched id past
    the min-tokens floor, or lands on the budget edge. Like
    :func:`stop_flags`, it may under-stop, never over-stop."""
    R = sampled.shape[1]
    dev = sampled.device
    gen = torch.arange(1, R + 1, dtype=torch.int32, device=dev)[None, :]
    if gen_base is not None:
        gen = gen + gen_base[:, None]
    emitted = torch.arange(R, dtype=torch.int32, device=dev)[None, :] <= accepted[:, None]
    watch_hit = (sampled[:, :, None] == watch[:, None, :]).any(dim=2)
    hit = (watch_hit & (gen >= min_left[:, None])) | (gen >= budgets[:, None])
    return (hit & emitted).any(dim=1)


def ring_append(
    hist: torch.Tensor,      # [S, H] int32 — right-aligned history ring, -1 padded
    hist_len: torch.Tensor,  # [S] int32 — valid tokens (right-aligned)
    emitted: torch.Tensor,   # [S, E] int32 — row-packed fresh tokens
    count: torch.Tensor,     # [S] int32 in [0, E] — valid prefix of ``emitted``
) -> tuple[torch.Tensor, torch.Tensor]:  # (hist' [S, H], hist_len' [S])
    """Shift ``count`` fresh tokens into each lane's history ring: a
    per-lane gather over ``cat([hist, emitted])`` at offset ``count``
    (newest token at column H - 1). ``count == 0`` is the identity, so dead
    lanes and non-drafting rows ride the same graph; slots of ``emitted``
    past ``count`` are never read."""
    H = hist.shape[1]
    buf = torch.cat([hist, emitted.to(hist.dtype)], dim=1)
    idx = torch.arange(H, device=hist.device)[None, :] + count.long()[:, None]
    return torch.gather(buf, 1, idx), torch.clamp(hist_len + count, max=H).to(hist_len.dtype)


def device_ngram_draft(
    hist: torch.Tensor,       # [S, H] int32 — right-aligned history ring, -1 padded
    hist_len: torch.Tensor,   # [S] int32 — valid tokens (min(true length, H))
    window: torch.Tensor,     # [S] int32 — per-lane lookback bound (<= H)
    ngram_min: torch.Tensor,  # [S] int32
    ngram_max: torch.Tensor,  # [S] int32 (<= ngram_max_static)
    k_cap: torch.Tensor,      # [S] int32 — draft budget this round (<= 0 disables)
    *,
    ngram_max_static: int,    # engine-wide suffix-length bound (unrolled loop)
    slots: int,               # draft slots of the verify row (spec_k)
) -> tuple[torch.Tensor, torch.Tensor]:  # (draft [S, slots] -1 padded, draft_len [S])
    """The prompt-lookup drafter on the device: a replay of
    :func:`dynamo_tpu_torch.spec.ngram.propose_ngram` over each lane's
    history ring, which holds exactly the tail the host drafter is handed
    (the last ``window + ngram_max`` tokens). Longest suffix first (n
    from ``ngram_max_static`` down, lanes selecting ``ngram_min <= n <=
    min(ngram_max, hist_len - 1)``); the most recent occurrence (the
    largest start); starts before ``H - min(hist_len, window)`` masked;
    the follow-on run cut at the ring end and at ``k_cap``. A lane with
    no match drafts nothing (``draft_len`` 0, slots -1). Plain tensor
    compares over ``[S, H]``, as in the JAX engine, where no Pallas
    kernel runs it either."""
    S, H = hist.shape
    dev = hist.device
    r_lo = H - torch.minimum(hist_len, window)  # [S] first in-window start
    found = torch.zeros(S, dtype=torch.bool, device=dev)
    best_r = torch.zeros(S, dtype=torch.int32, device=dev)
    best_n = torch.zeros(S, dtype=torch.int32, device=dev)
    for n in range(ngram_max_static, 0, -1):
        if n >= H:
            continue
        width = H - n  # candidate starts r in [0, H - n - 1]
        m = torch.ones((S, width), dtype=torch.bool, device=dev)
        for t in range(n):
            m = m & (hist[:, t : width + t] == hist[:, H - n + t][:, None])
        cand = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        rn = torch.where(m & (cand >= r_lo[:, None]), cand, -1).amax(dim=1)
        sel = (ngram_min <= n) & (n <= torch.minimum(ngram_max, hist_len - 1))
        upd = ~found & sel & (rn >= 0)
        best_r = torch.where(upd, rn, best_r)
        best_n = torch.where(upd, n, best_n).to(torch.int32)
        found = found | upd
    avail = H - (best_r + best_n)  # follow-on room to the ring end (>= 1)
    d = torch.clamp(torch.where(found, torch.minimum(k_cap, avail), 0), min=0).to(torch.int32)
    j = torch.arange(slots, dtype=torch.int32, device=dev)[None, :]
    src = torch.clamp(best_r[:, None] + best_n[:, None] + j, 0, H - 1)
    draft = torch.gather(hist, 1, src.long())
    return torch.where(j < d[:, None], draft, -1).to(torch.int32), d


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
    key: torch.Tensor | None,    # [B, 2] per-lane threefry keys
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

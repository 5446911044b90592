"""Model-free n-gram / prompt-lookup drafter.

Proposes up to ``k`` continuation tokens by matching the sequence's
recent suffix against its OWN prompt+output history: if the last ``n``
tokens appeared earlier in the context, the tokens that followed that
occurrence are likely to follow again (the prompt-lookup decoding trick —
strongest on extraction/summarization/code-edit workloads, where the
output quotes its input). Deterministic, zero device work, CPU-testable.

The drafter never affects output content — verification accepts only
tokens the target model would have chosen anyway (engine/core.py) — so a
bad draft costs wasted verify rows, never wrong tokens.
"""

from __future__ import annotations


def propose_ngram(
    context: list[int],
    k: int,
    ngram_min: int = 1,
    ngram_max: int = 3,
    window: int = 1024,
) -> list[int]:
    """Draft up to ``k`` tokens continuing ``context``.

    Tries suffix lengths ``ngram_max`` down to ``ngram_min``; for each,
    scans the last ``window`` tokens right-to-left for the most recent
    earlier occurrence of that suffix and proposes the tokens that
    followed it. Returns [] when nothing matches (the caller falls back
    to a plain 1-token decode row).
    """
    L = len(context)
    if L < 2 or k <= 0:
        return []
    lo = max(0, L - window)
    for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
        suffix = context[L - n:]
        first = suffix[0]
        # Most recent earlier occurrence wins: recent history predicts
        # the immediate continuation better than the distant prompt.
        # The first-token guard keeps the no-match worst case (the
        # incompressible-output workload) at one int compare per
        # position instead of one list-slice allocation per position —
        # this scan runs on the host per speculating lane per step, so
        # its constant factor is decode-path cost.
        for start in range(L - n - 1, lo - 1, -1):
            if context[start] != first:
                continue
            if n == 1 or context[start : start + n] == suffix:
                follow = context[start + n : start + n + k]
                if follow:
                    return follow
                break  # suffix only recurs at the very end: shorter n
    return []

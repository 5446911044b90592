"""Speculative-decoding configuration: engine defaults + per-request
overrides. A copy of ``dynamo_tpu/spec/config.py``.

The engine ships a default policy in :class:`EngineConfig`
(``spec_decode`` / ``spec_k`` / ``spec_ngram_*``); a request may override
it through the OpenAI ``dyn.spec_decode`` extension, which rides
:class:`PreprocessedRequest.spec_decode` over the data plane. Resolution
happens once, at admission, into an immutable :class:`SpecConfig` on the
sequence.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

#: Draft methods the engine implements. "off" is only valid as a request
#: override (it disables an engine-level default for that request).
SPEC_METHODS = ("ngram",)


@dataclass(frozen=True)
class SpecConfig:
    """Resolved per-sequence speculation policy.

    ``k`` is the draft length per verify step — the verify row is
    ``k+1`` query tokens. ``ngram_min``/``ngram_max`` bound the suffix
    lengths the prompt-lookup drafter tries (longest first);
    ``window`` bounds how far back it searches (host CPU cost per draft
    is O(window * ngram_max)).
    """

    method: str = "ngram"
    k: int = 4
    ngram_min: int = 1
    ngram_max: int = 3
    window: int = 1024
    #: Draft ON DEVICE between megastep inner iterations: the
    #: lane carries a packed history ring through the scanned body and
    #: redrafts after every accept/reject, so multiple draft rounds ride
    #: one dispatch. Requires the engine flag — a request can only turn
    #: it off (the ring buffers are sized at engine construction).
    device: bool = False

    def __post_init__(self) -> None:
        if self.method not in SPEC_METHODS:
            raise ValueError(
                f"unknown spec-decode method {self.method!r} "
                f"(expected one of {SPEC_METHODS})"
            )
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{self.ngram_min}, {self.ngram_max}]"
            )


def resolve_spec_config(
    default: SpecConfig | None,
    request: dict[str, Any] | None,
    k_cap: int,
) -> SpecConfig | None:
    """Merge the engine default with a request's ``spec_decode`` dict.

    Returns None when speculation is off for this sequence. The
    per-request ``k`` is clamped to ``k_cap`` (the engine's configured
    ``spec_k``): the verify program's sample-gather width is static, so a
    request cannot widen it. Unknown methods raise — admission is the
    right place to reject, not the first verify step.
    """
    if request is None:
        return default
    method = request.get("method", default.method if default else "ngram")
    if method in ("off", None):
        return None
    base = default or SpecConfig(method=method, k=k_cap)
    # Every knob clamps to the engine baseline, not just k: the drafter
    # scan is host CPU on the decode path, so an unclamped per-request
    # ngram_max/window would let one client request inject O(window x
    # ngram_max) work into every engine step for every co-scheduled lane.
    return SpecConfig(
        method=method,
        k=max(1, min(int(request.get("k", base.k)), k_cap)),
        ngram_min=max(1, int(request.get("ngram_min", base.ngram_min))),
        ngram_max=min(int(request.get("ngram_max", base.ngram_max)), base.ngram_max),
        window=min(int(request.get("window", base.window)), base.window),
        # Device drafting clamps like every other knob: the engine sized
        # its ring buffers (window + ngram_max) at construction, so a
        # request may opt out but never opt in past the engine baseline.
        device=bool(request.get("device", base.device)) and base.device,
    )

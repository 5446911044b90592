"""Speculation accounting shared by the real engine and the mocker.

One instance per engine; every verify step feeds it and the derived
gauges export on ``/metrics`` (status_server.SPEC_GAUGES) and publish in
``ForwardPassMetrics.spec_decode`` — the wire field that predates this
subsystem (llm/kv_router/protocols.py).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SpecStats:
    verify_steps: int = 0      # dispatches that carried >= 1 verify row
    verify_rows: int = 0       # speculating rows across those dispatches
    drafted_tokens: int = 0    # draft tokens proposed (and verified)
    accepted_tokens: int = 0   # draft tokens the target agreed with
    emitted_tokens: int = 0    # tokens emitted by verify rows (accept + 1)
    device_rounds: int = 0     # on-device draft rounds ridden inside dispatches
    device_hits: int = 0       # device rounds whose ring match proposed >= 1 token

    @property
    def wasted_tokens(self) -> int:
        """Draft tokens computed by the verify program and thrown away
        (the speculation-loss side of the A/B)."""
        return self.drafted_tokens - self.accepted_tokens

    @property
    def acceptance_rate(self) -> float:
        return (
            self.accepted_tokens / self.drafted_tokens
            if self.drafted_tokens
            else 0.0
        )

    @property
    def mean_accepted_len(self) -> float:
        """Mean tokens emitted per speculating row per step (>= 1.0; the
        dispatch-amortization factor speculation buys)."""
        return self.emitted_tokens / self.verify_rows if self.verify_rows else 0.0

    @property
    def dispatches_per_accepted_token(self) -> float:
        """Device dispatches per accepted draft token — the amortization
        gauge on-device drafting moves (lower is better; 0 when no draft
        token has been accepted yet)."""
        return (
            self.verify_steps / self.accepted_tokens
            if self.accepted_tokens
            else 0.0
        )

    def observe_row(self, drafted: int, accepted: int) -> None:
        """Account one verify row: ``drafted`` proposed, ``accepted``
        matched; the row emitted ``accepted + 1`` tokens (the bonus /
        correction token is free)."""
        self.verify_rows += 1
        self.drafted_tokens += drafted
        self.accepted_tokens += accepted
        self.emitted_tokens += accepted + 1

    def as_dict(self) -> dict:
        return {
            "verify_steps": self.verify_steps,
            "verify_rows": self.verify_rows,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "wasted_tokens": self.wasted_tokens,
            "emitted_tokens": self.emitted_tokens,
            "acceptance_rate": self.acceptance_rate,
            "mean_accepted_len": self.mean_accepted_len,
            "device_rounds": self.device_rounds,
            "device_hits": self.device_hits,
            "dispatches_per_accepted_token": self.dispatches_per_accepted_token,
        }

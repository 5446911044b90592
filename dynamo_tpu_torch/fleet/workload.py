"""Synthetic multi-tenant workload generator for the fleet harness.

The port's copy of ``dynamo_tpu/fleet/workload.py``, held to it by
``tests/test_torch_copies.py``.

User populations with a quadratic skew, a diurnal rate per tenant,
optional square-wave bursts, and a shared system prompt per tenant.
Arrivals are generated once per seed and replayed identically by every
scenario, so per-request streams compare byte for byte across runs. All
prompt lengths are block-aligned.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field

import numpy as np


def tenant_hue(name: str) -> int:
    """Stable per-tenant token hue for shared-prefix content. crc32, not
    builtin hash(): PYTHONHASHSEED randomizes hash() per process, which
    would make bench artifacts and cross-run byte-identity assertions
    irreproducible."""
    return zlib.crc32(name.encode()) % 199


@dataclass(frozen=True)
class TenantSpec:
    name: str
    users: int = 100_000
    rps: float = 10.0                  # mean aggregate requests/s
    diurnal_amplitude: float = 0.0     # 0.6 → 4x peak/trough swing
    diurnal_period_s: float = 240.0
    phase: float = 0.0                 # fraction of a period
    burst_rps: float = 0.0
    burst_every_s: float = 0.0
    burst_len_s: float = 0.0
    isl: int = 128                     # prompt tokens incl. shared prefix
    osl: int = 24                      # completion tokens
    shared_prefix_tokens: int = 64     # leading tokens all users share
    deadline_ms: float | None = None   # queue-expiry budget (typed shed)


@dataclass
class Arrival:
    t: float
    rid: str
    tenant: str
    user: int
    token_ids: list[int] = field(repr=False)
    osl: int = 24
    deadline_ms: float | None = None


def rate_at(spec: TenantSpec, t: float) -> float:
    """Instantaneous arrival rate of a tenant at virtual time ``t``."""
    rate = spec.rps
    if spec.diurnal_amplitude:
        rate *= 1.0 + spec.diurnal_amplitude * math.sin(
            2 * math.pi * (t / spec.diurnal_period_s + spec.phase)
        )
    if spec.burst_rps and spec.burst_every_s:
        if (t % spec.burst_every_s) < spec.burst_len_s:
            rate += spec.burst_rps
    return max(0.0, rate)


def _align(tokens: int, block_size: int) -> int:
    return max(block_size, (tokens // block_size) * block_size)


def generate_arrivals(
    tenants: list[TenantSpec],
    duration_s: float,
    seed: int = 0,
    block_size: int = 8,
    dt: float = 0.25,
) -> list[Arrival]:
    """The time-sorted arrival list, deterministic per seed.

    Poisson counts per ``dt`` bucket at the tenant's instantaneous rate,
    uniform jitter inside the bucket. Token values are small ints derived
    from (tenant, user): the shared prefix is one object per tenant (the
    population's system prompt), the user tail recurs whenever the user
    does — so the prefix-cache and peer-pull dynamics are real, while the
    mocker's output tokens stay the deterministic a..z cycle that makes
    cross-scenario streams byte-comparable."""
    rng = np.random.default_rng(seed)
    arrivals: list[Arrival] = []
    n_rid = 0
    tails: dict[tuple[str, int], list[int]] = {}
    for spec in tenants:
        prefix_len = _align(spec.shared_prefix_tokens, block_size)
        tail_len = max(
            block_size, _align(spec.isl, block_size) - prefix_len
        )
        th = tenant_hue(spec.name)
        prefix = [(th + i) % 251 for i in range(prefix_len)]
        t = 0.0
        while t < duration_s:
            n = rng.poisson(rate_at(spec, t) * dt)
            if n:
                offsets = np.sort(rng.random(n)) * dt
                # Quadratic user skew: heavy users (small ids) recur.
                users = (rng.random(n) ** 2 * spec.users).astype(np.int64)
                for off, user in zip(offsets, users):
                    user = int(user)
                    tail = tails.get((spec.name, user))
                    if tail is None:
                        uh = (th * 1009 + user * 31) % 249
                        tail = [(uh + 2 + i) % 251 for i in range(tail_len)]
                        tails[(spec.name, user)] = tail
                    arrivals.append(
                        Arrival(
                            t=round(t + float(off), 6),
                            rid=f"{spec.name}-{n_rid}",
                            tenant=spec.name,
                            user=user,
                            token_ids=prefix + tail,
                            osl=spec.osl,
                            deadline_ms=spec.deadline_ms,
                        )
                    )
                    n_rid += 1
            t += dt
    arrivals.sort(key=lambda a: (a.t, a.rid))
    return arrivals

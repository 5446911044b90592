"""Fleet-scale harness: tens of mocker workers on one virtual clock.

The port's copy of ``dynamo_tpu/fleet/__init__.py``, held to it by
``tests/test_torch_copies.py``.

A synthetic multi-tenant workload, the closed-loop planner in the loop,
and chaos plans: the environment the autoscaling and network-aware
routing claims are checked in.
"""

from dynamo_tpu_torch.fleet.harness import (
    ChaosEvent,
    FleetHarness,
    FleetReport,
    FleetSpec,
    SimConnector,
    mocker_profile,
    run_fleet_ab,
    run_routing_ab,
)
from dynamo_tpu_torch.fleet.workload import Arrival, TenantSpec, generate_arrivals, rate_at

__all__ = [
    "Arrival",
    "ChaosEvent",
    "FleetHarness",
    "FleetReport",
    "FleetSpec",
    "SimConnector",
    "TenantSpec",
    "generate_arrivals",
    "mocker_profile",
    "rate_at",
    "run_fleet_ab",
    "run_routing_ab",
]

"""The port's SLA profiler (``dynamo_tpu_torch.tools.profile_sla``) against
the JAX package's (``benchmarks/profile_sla.py``): the same grids and keys
at ``--preset tiny --quick`` on the CPU, and a profile both packages'
planners load and plan from. In process, on the plain versions."""

import json

import pytest

from dynamo_tpu.planner.perf_interpolation import from_profile as jax_from_profile
from dynamo_tpu.planner.planner_core import Observation as JaxObservation
from dynamo_tpu.planner.planner_core import Planner as JaxPlanner
from dynamo_tpu.planner.planner_core import RecordingConnector as JaxConnector
from dynamo_tpu.planner.planner_core import SlaTargets as JaxSla
from dynamo_tpu_torch.planner.perf_interpolation import from_profile
from dynamo_tpu_torch.planner.planner_core import (
    Observation,
    Planner,
    RecordingConnector,
    SlaTargets,
)
from dynamo_tpu_torch.tools import profile_sla


@pytest.fixture(scope="module")
def profile(tmp_path_factory):
    out = tmp_path_factory.mktemp("sla") / "profile.json"
    got = profile_sla.main(["--preset", "tiny", "--quick", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    return got


def test_profile_has_the_jax_profilers_grids_and_keys(profile):
    """What ``tests/test_sla_profiler.py`` asserts of the JAX profiler."""
    assert profile["prefill"]["isl"] == [16.0, 32.0, 64.0]
    assert len(profile["prefill"]["ttft_s"]) == 3
    assert all(t > 0 for t in profile["prefill"]["ttft_s"])
    assert profile["decode"]["concurrency"] == [1.0, 4.0]
    assert len(profile["decode"]["itl_s"]) == 2
    assert all(t > 0 for t in profile["decode"]["itl_s"])
    assert profile["meta"] | {"preset": "tiny", "ctx": 32, "osl": 8, "device": "cpu"} == (
        profile["meta"])


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_both_planners_plan_from_it(profile, package):
    load, planner_cls, connector, sla, obs = {
        "torch": (from_profile, Planner, RecordingConnector, SlaTargets, Observation),
        "jax": (jax_from_profile, JaxPlanner, JaxConnector, JaxSla, JaxObservation),
    }[package]
    pf, dc = load(profile)
    planner = planner_cls(pf, dc, connector(), sla=sla(ttft_s=10.0, itl_s=10.0))
    plan = planner.compute_plan(obs(request_rate=1.0, mean_isl=32, mean_osl=8))
    assert plan.decode_replicas >= 1 and plan.prefill_replicas >= 1


def test_cuda_refuses_without_a_card_or_for_f32(monkeypatch, tmp_path):
    """``--device cuda`` never runs on the CPU: without a card it raises;
    with one, the f32 ``tiny`` preset passes the card's check (K1's generic
    instance runs it) and a model no K1 instance runs (the tiny preset at
    head_dim 264) is refused before a sweep."""
    import dataclasses

    import torch

    from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig
    from dynamo_tpu_torch.engine.core import check_slice

    out = str(tmp_path / "p.json")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        profile_sla.main(["--preset", "tiny", "--quick", "--out", out])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    check_slice(PRESETS["tiny"](), EngineConfig(), "cuda")
    tiny = PRESETS["tiny"]
    monkeypatch.setitem(PRESETS, "tiny", lambda: dataclasses.replace(tiny(), head_dim=264))
    with pytest.raises(ValueError, match="cannot run on the card's attention kernel"):
        profile_sla.main(["--preset", "tiny", "--quick", "--out", out])

"""SLA autoscaling planner (parity: reference components/planner).

The port's copy of ``dynamo_tpu/planner/__init__.py``, held to it by
``tests/test_torch_copies.py``.
"""

from dynamo_tpu_torch.planner.load_predictor import (
    ARPredictor,
    ConstantPredictor,
    MovingAveragePredictor,
    PREDICTORS,
)
from dynamo_tpu_torch.planner.perf_interpolation import (
    DecodeInterpolator,
    PrefillInterpolator,
    from_profile,
)
from dynamo_tpu_torch.planner.controller import (
    ControllerConfig,
    PlannerController,
)
from dynamo_tpu_torch.planner.planner_core import (
    Connector,
    Observation,
    Plan,
    Planner,
    PlannerConfig,
    RecordingConnector,
    SlaTargets,
)

__all__ = [
    "ARPredictor",
    "ConstantPredictor",
    "Connector",
    "ControllerConfig",
    "DecodeInterpolator",
    "MovingAveragePredictor",
    "Observation",
    "PREDICTORS",
    "Plan",
    "Planner",
    "PlannerConfig",
    "PlannerController",
    "PrefillInterpolator",
    "RecordingConnector",
    "SlaTargets",
    "from_profile",
]

"""Engine construction for the PyTorch backend.

Counterpart of ``dynamo_tpu/backends/jax/main.py:build_engine``. The
worker CLI around it (store registration, data plane, KV events) is the
control-plane slice of the port (``ROADMAP.md`` A6).
"""

from __future__ import annotations

from typing import Any

from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig, tiny_engine
from dynamo_tpu_torch.engine.core import EngineCore, resolve_device
from dynamo_tpu_torch.engine.engine import TorchEngine


def build_engine(
    preset: str,
    engine_overrides: dict[str, Any] | None = None,
    seed: int = 0,
    eos_token_ids: tuple[int, ...] = (),
    device="cuda",
    params: dict | None = None,
) -> tuple[EngineCore, TorchEngine]:
    """Construct (EngineCore, TorchEngine) for a model preset.

    Runs on the card unless the caller passes ``device="cpu"``; with
    ``device="cuda"`` and no card it raises. ``params`` takes converted
    weights (``engine/convert.py``) or another engine's ``core.params``;
    None draws random weights from ``seed``. The tiny presets use the tiny
    engine shape, every other preset the ``EngineConfig`` defaults.
    """
    dev = resolve_device(device)
    model_cfg = PRESETS[preset]()
    overrides = dict(engine_overrides or {})
    if preset in ("tiny", "tiny-moe"):
        engine_cfg = tiny_engine(**overrides)
    else:
        engine_cfg = EngineConfig(**overrides)
    core = EngineCore(
        model_cfg, engine_cfg, params=params, seed=seed,
        eos_token_ids=eos_token_ids, device=dev,
    )
    return core, TorchEngine(core)

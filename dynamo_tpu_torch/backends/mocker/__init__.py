"""The mocker backend worker."""

from dynamo_tpu_torch.backends.mocker.main import run_mocker

__all__ = ["run_mocker"]

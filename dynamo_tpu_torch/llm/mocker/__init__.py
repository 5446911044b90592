"""The mock engine: a timing-faithful fake worker for cluster-free tests."""

from dynamo_tpu_torch.llm.mocker.engine import MockEngineArgs, MockTpuEngine
from dynamo_tpu_torch.llm.mocker.kv_manager import MockKvManager

__all__ = ["MockEngineArgs", "MockKvManager", "MockTpuEngine"]

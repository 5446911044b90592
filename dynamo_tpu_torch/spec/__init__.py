"""dynamo_tpu_torch.spec — speculative decoding (draft-and-verify).

A copy of ``dynamo_tpu/spec``. A speculating sequence drafts up to ``k``
continuation tokens with a model-free drafter, then the engine verifies
pending + draft as ONE ``q_len=k+1`` row of the same ragged forward that
serves prefill chunks and decode rows (``engine/core.py``), so one
dispatch emits several tokens. Verification samples the target model's
own per-lane (seed, counter)-keyed choice at every drafted position, so
accepted output equals non-speculative decoding for greedy and seeded
temperature lanes; the drafter only decides how many of those choices
land per dispatch.
"""

from dynamo_tpu_torch.spec.config import SpecConfig, resolve_spec_config
from dynamo_tpu_torch.spec.ngram import propose_ngram
from dynamo_tpu_torch.spec.stats import SpecStats

__all__ = [
    "SpecConfig",
    "SpecStats",
    "propose_ngram",
    "resolve_spec_config",
]

"""Parallelism for the port, one process per rank: tensor and data
parallelism (``sharding``), pipeline parallelism (``pipeline``), their
collectives and stage hops (``comm``), joining the ranks (``multihost``)
and memory planning (``placement``). Counterpart of
``dynamo_tpu/parallel/``. Sequence-parallel ring prefill keeps its JAX
home: ``ops/ring_attention.py``, its ring exchanges in ``comm``."""

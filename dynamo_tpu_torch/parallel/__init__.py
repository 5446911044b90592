"""Parallelism for the port, one process per rank: tensor and data
parallelism (``sharding``), pipeline parallelism (``pipeline``), their
collectives and stage hops (``comm``), joining the ranks (``multihost``)
and memory planning (``placement``). Counterpart of
``dynamo_tpu/parallel/``; sequence-parallel ring prefill is not ported
yet (``ROADMAP.md`` A12c)."""

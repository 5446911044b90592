"""Parallelism for the port: tensor parallelism over one process per rank
(``sharding``, ``comm``, ``multihost``) and memory planning
(``placement``). Counterpart of ``dynamo_tpu/parallel/``; pipeline
parallelism (``pipeline.py``) is not ported yet (``ROADMAP.md`` A12b)."""

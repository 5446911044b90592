"""Observability pieces a worker runs: the flight recorder
(``obs/flight_recorder.py``), dumped on drain and on a stalled stream.

The snapshot publisher, the fleet aggregator and the SLO scanner of
``dynamo_tpu/obs`` wait for ``ROADMAP.md`` A6b.
"""

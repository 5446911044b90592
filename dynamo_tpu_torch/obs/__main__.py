"""CLI: ``python -m dynamo_tpu_torch.obs`` — the standalone fleet aggregator.

The port's copy of ``dynamo_tpu/obs/__main__.py``, held to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import argparse

from dynamo_tpu_torch.obs.service import run_aggregator
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime.worker import dynamo_worker


def main() -> None:
    ap = argparse.ArgumentParser(
        description="dynamo-tpu fleet metrics aggregator"
    )
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8082)
    ap.add_argument(
        "--stale-after-s", type=float, default=10.0,
        help="retire a worker's series after this long without a "
             "snapshot (the dead-process backstop; drain and lease loss "
             "retire immediately)",
    )
    args = ap.parse_args()

    @dynamo_worker()
    async def entry(runtime: DistributedRuntime) -> None:
        await run_aggregator(
            runtime,
            namespace=args.namespace,
            host=args.host,
            port=args.port,
            stale_after_s=args.stale_after_s,
        )

    entry()


if __name__ == "__main__":
    main()

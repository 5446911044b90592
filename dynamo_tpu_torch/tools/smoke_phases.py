"""The smoke's tp and disaggregation phases alone, from one checkout.

Run from the root of a checkout on a machine with one CUDA card::

    python3 -m dynamo_tpu_torch.tools.smoke_phases NAME [--no-disagg]

or, to run the same phases from another checkout (an older tree, to
compare two trees on one card in turns), from that checkout's root::

    python3 /path/to/smoke_phases.py NAME [--no-disagg]

It imports ``chip_smoke.py`` and the port from the current directory,
builds an llama3-8b engine cut to the smoke's ``DISAGG_LAYERS`` layers
(random weights from seed 0), writes its checkpoint, computes the tp = 1
references (``tp_reference``), then runs ``serve_tp`` and, unless
``--no-disagg``, ``serve_disagg`` on that checkpoint, as the smoke does.
Its last line is ``PHASES`` and one JSON object: ``NAME``, the card, the
phases' seconds, each tp rank's decode ms per iteration, the tp worker's
start-up and the disaggregation phase's summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", help="a label for this tree, echoed in the result")
    ap.add_argument("--no-disagg", action="store_true", help="run the tp phase only")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from dynamo_tpu_torch.engine.config import EngineConfig, llama3_8b
    from dynamo_tpu_torch.engine.core import EngineCore

    t0 = time.time()
    card = cs.card_line()
    cfg = dataclasses.replace(llama3_8b(), num_layers=cs.DISAGG_LAYERS)
    core = EngineCore(cfg, EngineConfig(num_kv_blocks=512), device="cuda")
    ck = cs.write_cut_checkpoint(core, cs.DISAGG_LAYERS)
    try:
        ref = cs.tp_reference(core)
        del core
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.time()
        tp = cs.serve_tp(card, ck["dir"], ref)
        t2 = time.time()
        disagg = {} if args.no_disagg else cs.serve_disagg(card, ck["dir"])
        t3 = time.time()
        disagg.pop("agg_runs", None)
        out = {"name": args.name, "card": card, "setup_s": t1 - t0, "tp_s": t2 - t1,
               "disagg_s": t3 - t2,
               "tp_decode_ms": [r["decode_ms_per_iteration"] for r in tp["ranks"]],
               "tp_served_after_s": tp["served_after_s"], "disagg": disagg}
        print("PHASES " + json.dumps(out), flush=True)
    finally:
        shutil.rmtree(ck["dir"], ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

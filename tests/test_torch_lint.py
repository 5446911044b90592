"""The repository's linters over the port: ``tools/dynalint`` and
``tools/dynacheck``'s Engine A (the interprocedural rules), as
``tests/test_dynalint.py`` and ``tests/test_dynacheck.py`` hold the JAX
package to them.

The tools' tables key the JAX package's files. dynalint's rules read no
table of files, so ``dynamo_tpu_torch/`` must lint clean as it is, with
its in-source pragmas pinned here. Engine A's cursor discipline reads the
audited writers by file: they are re-keyed to the port's paths by a
monkeypatch (the tools stay as they are), and the port's own writers of a
cursor are added below, each with its reason.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

from tools.dynacheck import config as DC
from tools.dynacheck.__main__ import run
from tools.dynalint.linter import lint_paths

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dynamo_tpu_torch"

# The port's in-source dynalint pragmas: {(path, kind, arg): count}.
# Each is its JAX original's, in the copied or ported module.
LINT_PRAGMAS = {
    # The facade's per-request queue, fed by the engine loop of the same
    # process.
    ("dynamo_tpu_torch/engine/engine.py", "unbounded-ok", ""): 1,
    ("dynamo_tpu_torch/engine/kv_quant.py", "sync-ok", ""): 1,
    ("dynamo_tpu_torch/llm/disagg_pool/cursor.py", "unbounded-ok", ""): 1,
    ("dynamo_tpu_torch/llm/kv_router/netcost.py", "allow", "broad-except"): 1,
    ("dynamo_tpu_torch/llm/mocker/engine.py", "unbounded-ok", ""): 1,
    ("dynamo_tpu_torch/runtime/dataplane.py", "unbounded-ok", ""): 2,
    ("dynamo_tpu_torch/runtime/store/client.py", "unbounded-ok", ""): 2,
    ("dynamo_tpu_torch/runtime/store/server.py", "unbounded-ok", ""): 2,
}

# Cursor writers of the port's engine core beyond the JAX package's
# audited set (which holds the ring prefill's commit,
# ``EngineCore._run_ring_prefill``, writing ``seq.prefilled =
# seq.processed`` as JAX's does).
PORT_CURSOR_WRITERS = {
    # The commit of one lane's emission from a megastep or a verify row,
    # shared by every commit closure (JAX inlines it in each): the cursor
    # advances by the K/V the dispatch wrote, after the stop scan.
    "EngineCore._commit_emission",
    # Warm-up's stand-in sequence, never admitted: its cursor places the
    # decode rows of the graphs being captured and touches no live lane.
    "EngineCore._warm_up_launches",
}

# The port's in-source dynacheck pragmas: {(path, rule): count}.
CHECK_PRAGMAS = {
    # import_blocks_direct: two cores' step locks in a global id() order,
    # as in the JAX original.
    ("dynamo_tpu_torch/engine/core.py", "lock-order"): 1,
}


def test_dynalint_over_port_is_clean():
    res = lint_paths([PORT], REPO)
    assert res.findings == [], "\n".join(str(f) for f in res.findings)
    counts = Counter((p.path, p.kind, p.arg) for p in res.pragmas)
    assert dict(counts) == LINT_PRAGMAS, dict(counts)


def test_dynacheck_engine_a_over_port_is_clean(monkeypatch):
    writers = {k.replace("dynamo_tpu/", "dynamo_tpu_torch/", 1): set(v)
               for k, v in DC.AUDITED_CURSOR_WRITERS.items()}
    writers["dynamo_tpu_torch/engine/core.py"] |= PORT_CURSOR_WRITERS
    monkeypatch.setattr(DC, "AUDITED_CURSOR_WRITERS", writers)
    rep = run([PORT], REPO, engine="a", use_cache=False)
    assert rep.findings == [], "\n".join(str(f) for f in rep.findings)
    assert dict(Counter((p.path, p.rule) for p in rep.pragmas)) == CHECK_PRAGMAS

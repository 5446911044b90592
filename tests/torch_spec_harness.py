"""Shared harness of the port's speculative-decoding parity tests
(``test_torch_spec_*.py``): the tiny preset's weights in both packages,
request wires, engines of either package, a helper that runs a batch to
its end, and one run per configuration of the speculation workload, shared
by the tests of a file through its module-scoped fixture."""

import jax
import numpy as np

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

LOGIT_TOL = 1e-4
LP_TOL = 1e-4
CACHE_TOL = 1e-5
SPEC = {"spec_decode": "ngram", "spec_k": 4}
CHUNKED = {"scheduling": "chunked", "prefill_chunk": 32}
# Repetitive prompts give the prompt-lookup drafter matches, so accepted
# drafts (not only rejected ones) are exercised.
REPEAT_PROMPT = [5, 6, 7, 8] * 6
RANDOM_PROMPT = [int(t) for t in np.random.RandomState(0).randint(1, 200, size=40)]
DISPATCH_KEYS = ("dispatches", "commits", "drains", "megastep_dispatches",
                 "single_step_dispatches", "fused_mixed_dispatches", "committed_tokens",
                 "preemptions", "mixed_steps", "megastep_forced_single", "dispatches_per_token")


def make_weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), j_tiny_model())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")
    return jparams, tparams


def wire(prompt, rid, max_tokens=8, temperature=0.0, seed=None, top_k=0, top_p=1.0,
          logprobs=None, spec=None, **stop):
    w = {
        "model": "tiny", "token_ids": [int(t) for t in prompt], "request_id": rid,
        "sampling": {"temperature": temperature, "seed": seed, "top_k": top_k, "top_p": top_p},
        "stop": {"max_tokens": max_tokens, **stop},
    }
    if logprobs is not None:
        w["output"] = {"logprobs": logprobs}
    if spec is not None:
        w["spec_decode"] = spec
    return w


def make_core(pkg, weights, eos=(), **eng):
    if pkg == "jax":
        return JaxCore(j_tiny_model(), j_tiny_engine(**eng), params=weights[0], eos_token_ids=eos)
    return build_engine("tiny", eng, eos_token_ids=eos, device="cpu", params=weights[1])[0]


def drive(core, wires, max_steps=4000):
    """Run to completion, the pipeline's tail drained. Returns (tokens,
    finish reasons, logprob entries) by request id."""
    from_wire = JaxRequest.from_wire if isinstance(core, JaxCore) else PreprocessedRequest.from_wire
    seqs = [core.add_request(from_wire(w)) for w in wires]
    toks = {s.request_id: [] for s in seqs}
    fins: dict[str, str] = {}
    lps = {s.request_id: [] for s in seqs}
    for _ in range(max_steps):
        for s, out in core.step():
            toks[s.request_id].extend(out.token_ids)
            if out.logprobs:
                lps[s.request_id].extend(out.logprobs)
            if out.finish_reason:
                fins[s.request_id] = out.finish_reason
        if len(fins) == len(seqs) and not core.has_work():
            break
    assert len(fins) == len(seqs) and not core.has_work(), "engine did not finish"
    return toks, fins, lps


def assert_logprobs_close(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        assert len(a[rid]) == len(b[rid]), rid
        for x, y in zip(a[rid], b[rid]):
            assert x["token_id"] == y["token_id"]
            assert abs(x["logprob"] - y["logprob"]) <= LP_TOL
            assert [t for t, _ in x["top"]] == [t for t, _ in y["top"]]
            assert np.allclose([v for _, v in x["top"]], [v for _, v in y["top"]], atol=LP_TOL)


def spec_workload():
    """Greedy and seeded lanes on repetitive prompts (one with top-p and
    logprobs), an incompressible greedy lane, and a 100-token prompt whose
    chunks ride next to the verify rows under chunked scheduling."""
    rng = np.random.RandomState(7)
    return [
        wire(REPEAT_PROMPT, "rep", max_tokens=20, ignore_eos=True),
        wire(RANDOM_PROMPT, "rnd", max_tokens=12),
        wire([7, 8] * 6, "tmp", max_tokens=15, temperature=0.8, seed=21, ignore_eos=True,
             logprobs=2),
        wire([2, 4, 6] * 3, "tp", max_tokens=12, temperature=0.9, seed=22, top_p=0.85,
             logprobs=3, ignore_eos=True),
        wire(list(rng.randint(1, 200, size=100)), "long", max_tokens=6, ignore_eos=True),
    ]


def matrix_runner(weights, **extra):
    """A getter of one run per (scheduling, k) and engine: JAX and the
    port, sync and async, speculating (engine settings ``extra`` added);
    and the port with speculation off. Each run is made once."""
    runs: dict = {}

    def get(scheduling, k):
        key = (scheduling, k)
        if key not in runs:
            eng = {**SPEC, **extra, "megastep_k": k,
                   **(CHUNKED if scheduling == "chunked" else {})}
            out = {}
            for pkg in ("jax", "torch"):
                for async_exec in (False, True):
                    core = make_core(pkg, weights, **eng, async_exec=async_exec)
                    out[pkg, async_exec] = (drive(core, spec_workload()), core)
            off = {k2: v for k2, v in eng.items() if not k2.startswith("spec_")}
            out["torch_off"] = (drive(make_core("torch", weights, **off), spec_workload()), None)
            runs[key] = out
        return runs[key]

    return get

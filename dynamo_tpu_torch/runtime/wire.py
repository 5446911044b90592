"""Per-plane wire frame-key schema registry.

The port's copy of ``dynamo_tpu/runtime/wire.py``, held to it by
``tests/test_torch_copies.py``.

Every msgpack frame the tree sends is a dict with short keys. Those keys
ARE the wire contract: a producer writing a key nobody parses, or a
consumer parsing a key nobody sends, is protocol drift that no unit test
of either side catches. This module hoists every frame key into a named
constant, grouped by *plane* (one protocol surface = one schema), and
``tools/dynacheck``'s ``wire-contract`` rule statically checks that every
registered key is produced somewhere AND consumed somewhere in the tree,
that registered plane files don't backslide to raw string literals at
send sites, and that no two planes sharing a parse context reuse a key
string with conflicting meaning.

Planes and their parse contexts:

- ``dataplane``  — request/response envelope on worker ingress TCP
  (``runtime/dataplane.py``).
- ``store``      — control-plane store RPC envelope; op params splice
  into the envelope (``{ST_ID: ..., ST_OP: ..., **params}``), so the
  envelope and every op's params are ONE flat schema
  (``runtime/store/client.py`` / ``server.py``).
- ``store.event``— the event body carried inside a store push frame
  (watch events and bus messages); parsed from the ``ST_EVENT`` value,
  a different context than the envelope, so e.g. ``"r"`` may mean
  "rpc result" in the envelope and "delete reason" here without
  ambiguity.
- ``instance``   — discovery instance records (``Instance.to_wire``).
- ``snapshot``   — fleet metrics snapshot records (``obs/snapshot.py``).
- ``kvstream``   — KV block streams: peer prefix pulls AND disagg
  transfers (``llm/kv_pool/peer_client.py``, ``backends/*/main.py``).
- ``kvimport``   — per-block import descriptors handed to
  ``EngineCore.import_blocks`` (host-side record, same codec).
- ``disagg.cursor`` — per-request chunk-cursor events the prefill
  worker publishes on the event plane as committed KV blocks land
  (``llm/disagg_pool/cursor.py``); the decode worker's streaming
  handoff consumes them to pull chunks while prefill is still running.

Keep this module stdlib-only and leaf-level: the checker imports
nothing from it (it parses the AST), but product code imports it from
every layer.
"""

from __future__ import annotations

# -- dataplane envelope -----------------------------------------------------

DP_TYPE = "t"           # frame discriminator (see DP_T_* values)
DP_ID = "i"             # request id, pairs responses with requests
DP_ROUTE = "m"          # method / endpoint route name
DP_HEADERS = "h"        # control header map (two-part frame: control part)
DP_PAYLOAD = "p"        # opaque payload bytes (two-part frame: payload part)
DP_ERR = "err"          # error text on an error frame

DP_T_REQ = "req"        # client -> worker: start a request
DP_T_STOP = "stop"      # client -> worker: cooperative cancel
DP_T_KILL = "kill"      # client -> worker: hard cancel (stalled stream)
DP_T_RSP = "rsp"        # worker -> client: one response item
DP_T_END = "end"        # worker -> client: stream finished cleanly
DP_T_ERR = "err"        # worker -> client: stream failed

# -- store RPC envelope (+ spliced op params) -------------------------------

ST_ID = "i"             # rpc id, pairs responses with requests
ST_OP = "op"            # rpc op name
ST_OK = "ok"            # response: success flag
ST_RESULT = "r"         # response: op result
ST_ERR = "err"          # response: error text
ST_PUSH_SUB = "s"       # push frame: subscription id (presence = push)
ST_EVENT = "ev"         # push frame: event body (store.event schema)
ST_KEY = "k"            # kv op param: key
ST_VALUE = "v"          # kv op param/result: value
ST_REV = "rev"          # kv result: revision
ST_LEASE = "lease"      # kv/lease param+result: lease id
ST_CREATE_ONLY = "create_only"    # kv_put param: fail if key exists
ST_WITH_INITIAL = "with_initial"  # kv_watch param: replay current state
ST_SUB = "sub"          # watch/bus result+param: subscription id
ST_INITIAL = "initial"  # kv_watch result: initial replay events
ST_TTL = "ttl"          # lease param+result: ttl seconds
ST_WANT = "want"        # lease_grant param: resurrect this lease id
ST_CONN_BOUND = "conn_bound"      # lease_grant param: die with the conn
ST_SUBJECT = "subject"  # bus param: subject
ST_PAYLOAD = "p"        # bus/queue/object param: payload bytes
ST_QUEUE = "q"          # work-queue param: queue name
ST_TIMEOUT = "timeout"  # q_pop param: blocking wait seconds
ST_BUCKET = "b"         # object-store param: bucket
ST_NAME = "name"        # object-store param: object name

# -- store event body (inside ST_EVENT) -------------------------------------

EV_TYPE = "t"           # event discriminator (EV_PUT / EV_DELETE)
EV_KEY = "k"            # kv watch event: key
EV_VALUE = "v"          # kv watch event: value
EV_REV = "rev"          # kv watch event: revision
EV_REASON = "r"         # kv delete event: reason (EV_R_LEASE / EV_R_DEL)
EV_SUBJECT = "subject"  # bus message: subject
EV_PAYLOAD = "p"        # bus message: payload bytes

EV_PUT = "put"          # key created or updated
EV_DELETE = "delete"    # key removed
EV_R_LEASE = "lease"    # delete reason: lease expiry
EV_R_DEL = "del"        # delete reason: explicit delete

# -- discovery instance records ---------------------------------------------

INST_NS = "ns"          # namespace
INST_COMPONENT = "comp" # component name
INST_ENDPOINT = "ep"    # endpoint name
INST_ID = "id"          # instance id (lease id)
INST_ADDR = "addr"      # dataplane host:port
INST_META = "meta"      # optional metadata map

# -- fleet metrics snapshot records -----------------------------------------

SNAP_WORKER = "w"       # worker id
SNAP_ROLE = "r"         # worker role
SNAP_COMPONENT = "c"    # component name
SNAP_SEQ = "s"          # publisher sequence number
SNAP_TIME = "t"         # publish wall time
SNAP_EPOCH = "e"        # publisher epoch (restarts bump it)
SNAP_FAMILIES = "f"     # metric families map
SNAP_TENANTS = "tn"     # per-tenant rollups
SNAP_PHASES = "ph"      # per-phase latency rollups
SNAP_REQUESTS = "rq"    # per-request terminal records
SNAP_RETIRED = "x"      # tombstone flag: publisher retiring

# -- KV block streams (peer prefix pull + disagg transfer) ------------------

KV_HASHES = "hashes"    # pull request: block hash chain wanted
KV_CHUNK_BLOCKS = "chunk_blocks"  # request: blocks per data frame
KV_REQUEST_ID = "request_id"      # transfer request: prefill request id
KV_VERSION = "version"  # stream wire version
KV_SHAPE = "shape"      # geometry frame: per-block page shape
KV_DTYPE = "dtype"      # geometry frame: page dtype
KV_BLOCKS = "blocks"    # transfer descriptor frame: block descriptors
KV_START = "start"      # data frame: index of first block in this chunk
KV_PAGES = "kv"         # data frame: raw page bytes, one per block
KV_DONE = "done"        # trailer frame: total blocks sent
KV_HELD = "held"        # mocker data frame: held prefix length
KV_ERROR = "error"      # error frame: abort reason
KV_WINDOW_START = "ws"  # windowed transfer request: first committed block
KV_WINDOW_COUNT = "wc"  # windowed transfer request: max blocks this window
KV_WINDOW_FINAL = "wf"  # windowed transfer request: release the hold after

# -- disagg chunk-cursor events (streaming handoff, bus subject) ------------

CUR_REQUEST_ID = "rid"  # cursor event: prefill request id
CUR_WORKER = "w"        # cursor event: prefill worker id holding the blocks
CUR_COMMITTED = "c"     # cursor event: committed KV blocks so far
CUR_DONE = "d"          # cursor event: prefill finished (cursor is final)

# -- KV import descriptors (EngineCore.import_blocks) -----------------------

IMP_HASH = "hash"       # block content hash
IMP_PARENT = "parent"   # parent block hash (prefix chain)
IMP_SHAPE = "shape"     # page shape the bytes were serialized with
IMP_DTYPE = "dtype"     # page dtype the bytes were serialized with
IMP_KV = "kv"           # raw page bytes
IMP_LAYOUT = "layout"   # producer page-layout record (kind, tp, kv_dtype)

# ---------------------------------------------------------------------------
# Registry: plane -> {constant name -> meaning}. The dynacheck
# wire-contract rule reads THIS table (statically) and resolves each
# constant name against the assignments above.
# ---------------------------------------------------------------------------

SCHEMAS: dict[str, dict[str, str]] = {
    "dataplane": {
        "DP_TYPE": "frame discriminator",
        "DP_ID": "request id",
        "DP_ROUTE": "endpoint route",
        "DP_HEADERS": "control header map",
        "DP_PAYLOAD": "payload bytes",
        "DP_ERR": "error text",
    },
    "store": {
        "ST_ID": "rpc id",
        "ST_OP": "rpc op name",
        "ST_OK": "success flag",
        "ST_RESULT": "op result",
        "ST_ERR": "error text",
        "ST_PUSH_SUB": "push subscription id",
        "ST_EVENT": "push event body",
        "ST_KEY": "kv key",
        "ST_VALUE": "kv value",
        "ST_REV": "kv revision",
        "ST_LEASE": "lease id",
        "ST_CREATE_ONLY": "fail if key exists",
        "ST_WITH_INITIAL": "replay current state",
        "ST_SUB": "subscription id",
        "ST_INITIAL": "initial replay events",
        "ST_TTL": "lease ttl seconds",
        "ST_WANT": "resurrect lease id",
        "ST_CONN_BOUND": "lease dies with conn",
        "ST_SUBJECT": "bus subject",
        "ST_PAYLOAD": "payload bytes",
        "ST_QUEUE": "work queue name",
        "ST_TIMEOUT": "pop wait seconds",
        "ST_BUCKET": "object bucket",
        "ST_NAME": "object name",
    },
    "store.event": {
        "EV_TYPE": "event discriminator",
        "EV_KEY": "kv key",
        "EV_VALUE": "kv value",
        "EV_REV": "kv revision",
        "EV_REASON": "delete reason",
        "EV_SUBJECT": "bus subject",
        "EV_PAYLOAD": "payload bytes",
    },
    "instance": {
        "INST_NS": "namespace",
        "INST_COMPONENT": "component name",
        "INST_ENDPOINT": "endpoint name",
        "INST_ID": "instance id",
        "INST_ADDR": "dataplane address",
        "INST_META": "metadata map",
    },
    "snapshot": {
        "SNAP_WORKER": "worker id",
        "SNAP_ROLE": "worker role",
        "SNAP_COMPONENT": "component name",
        "SNAP_SEQ": "sequence number",
        "SNAP_TIME": "publish wall time",
        "SNAP_EPOCH": "publisher epoch",
        "SNAP_FAMILIES": "metric families",
        "SNAP_TENANTS": "tenant rollups",
        "SNAP_PHASES": "phase rollups",
        "SNAP_REQUESTS": "request records",
        "SNAP_RETIRED": "retiring tombstone",
    },
    "kvstream": {
        "KV_HASHES": "block hash chain wanted",
        "KV_CHUNK_BLOCKS": "blocks per data frame",
        "KV_REQUEST_ID": "prefill request id",
        "KV_VERSION": "stream wire version",
        "KV_SHAPE": "page shape",
        "KV_DTYPE": "page dtype",
        "KV_BLOCKS": "block descriptors",
        "KV_START": "first block index",
        "KV_PAGES": "raw page bytes",
        "KV_DONE": "total blocks sent",
        "KV_HELD": "held prefix length",
        "KV_ERROR": "abort reason",
        "KV_WINDOW_START": "window first block index",
        "KV_WINDOW_COUNT": "window max blocks",
        "KV_WINDOW_FINAL": "release hold after window",
    },
    "disagg.cursor": {
        "CUR_REQUEST_ID": "prefill request id",
        "CUR_WORKER": "prefill worker id",
        "CUR_COMMITTED": "committed blocks so far",
        "CUR_DONE": "prefill finished",
    },
    "kvimport": {
        "IMP_HASH": "block content hash",
        "IMP_PARENT": "parent block hash",
        "IMP_SHAPE": "page shape",
        "IMP_DTYPE": "page dtype",
        "IMP_KV": "raw page bytes",
        "IMP_LAYOUT": "producer page-layout record",
    },
}

# Parse context per plane: two planes may reuse one key string with
# DIFFERENT meanings only if their contexts differ (a reader always
# knows which context it is parsing). Same context + same key string +
# different meaning = ambiguity = a wire-contract finding.
CONTEXTS: dict[str, str] = {
    "dataplane": "dataplane-envelope",
    "store": "store-envelope",
    "store.event": "store-event-body",
    "instance": "instance-record",
    "snapshot": "snapshot-record",
    "kvstream": "kv-stream-frame",
    "kvimport": "kv-import-record",
    "disagg.cursor": "disagg-cursor-event",
}

# Discriminator VALUES (not keys): registered so the module self-check
# below accounts for every wire constant defined above.
VALUES: dict[str, str] = {
    "DP_T_REQ": "start a request",
    "DP_T_STOP": "cooperative cancel",
    "DP_T_KILL": "hard cancel",
    "DP_T_RSP": "one response item",
    "DP_T_END": "clean end of stream",
    "DP_T_ERR": "stream failed",
    "EV_PUT": "key created/updated",
    "EV_DELETE": "key removed",
    "EV_R_LEASE": "lease expiry",
    "EV_R_DEL": "explicit delete",
}


def _self_check() -> None:
    """Registry consistency, enforced at import: every schema constant
    exists, and every module-level wire constant is registered."""
    g = globals()
    for plane, schema in SCHEMAS.items():
        if plane not in CONTEXTS:
            raise AssertionError(f"plane {plane!r} has no parse context")
        for const in schema:
            if not isinstance(g.get(const), str):
                raise AssertionError(
                    f"SCHEMAS[{plane!r}] names {const}, which is not a "
                    "str constant in dynamo_tpu.runtime.wire"
                )
    registered = {c for s in SCHEMAS.values() for c in s} | set(VALUES)
    for name, value in g.items():
        if name.isupper() and isinstance(value, str) and name not in registered:
            raise AssertionError(
                f"wire constant {name} is not registered in SCHEMAS or VALUES"
            )


_self_check()

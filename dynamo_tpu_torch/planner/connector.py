"""Scaling connectors: turn a Plan into actual fleet changes.

The port's copy of ``dynamo_tpu/planner/connector.py``, held to it by
``tests/test_torch_copies.py``.

The reference scales by patching DynamoGraphDeployment replica counts and
letting the Kubernetes operator reconcile pods
(`components/planner/.../kubernetes_connector.py`, `kube.py`). This
environment has no cluster, so the production-shaped connector here
manages local worker PROCESSES: spawn to scale up, SIGTERM to scale
down. Scale-down is a *graceful drain*, never a kill: SIGTERM triggers
the worker's graceful drain (deregister → refuse new work → finish in-flight
→ revoke lease → exit), and only a worker that overstays the drain
window is escalated to SIGKILL. Exit codes are reaped on every
adjustment cycle so scaled-down children never linger as POSIX zombies
for the planner's lifetime. The discovery plane reacts exactly as it
would under an orchestrator — new workers register under store leases,
drained ones deregister themselves, and the frontend's watcher prunes
them.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import time
from typing import Sequence

from dynamo_tpu_torch import knobs

log = logging.getLogger("dynamo_tpu.planner.connector")


class LocalProcessConnector:
    def __init__(
        self,
        store_address: str,
        worker_argv: dict[str, Sequence[str]],
        env: dict[str, str] | None = None,
        drain_timeout_s: float | None = None,
    ):
        """``worker_argv`` maps component name ("prefill"/"decode"/...) to
        the argv that starts ONE worker of that kind, e.g.
        ``["-m", "dynamo_tpu.backends.mocker", "--model-name", "m"]``
        (interpreted relative to this interpreter).

        ``drain_timeout_s`` bounds how long a SIGTERM'd worker may spend
        draining before the connector escalates to SIGKILL; defaults to
        the worker-side drain budget (``DYN_WORKER_DRAIN_TIMEOUT_S``,
        30 s) plus slack, so a healthy drain always finishes first."""
        self.store_address = store_address
        self.worker_argv = {k: list(v) for k, v in worker_argv.items()}
        self.env = env or {}
        if drain_timeout_s is None:
            drain_timeout_s = knobs.get_float("DYN_WORKER_DRAIN_TIMEOUT_S") + 5.0
        self.drain_timeout_s = drain_timeout_s
        self._procs: dict[str, list[subprocess.Popen]] = {}
        # Scaled-down children pending exit: (proc, SIGKILL-escalation
        # deadline). poll()ed on every reap so exit codes are collected
        # promptly and overstayers are escalated.
        self._draining: list[tuple[subprocess.Popen, float]] = []
        # (pid, returncode) of every reaped child, in reap order — the
        # audit trail tests and operators read (0/-SIGTERM = clean drain,
        # -SIGKILL = escalated).
        self.exit_codes: list[tuple[int, int]] = []
        self.kills_escalated = 0

    def _reap_draining(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        still: list[tuple[subprocess.Popen, float]] = []
        for p, deadline in self._draining:
            rc = p.poll()
            if rc is not None:
                self.exit_codes.append((p.pid, rc))
                log.info("drained worker pid %d exited rc=%d", p.pid, rc)
                continue
            if now >= deadline:
                # Drain window blown: the worker is wedged (or its drain
                # is stuck behind a dead store). SIGKILL and keep polling
                # — the exit code lands on a later reap.
                log.warning(
                    "worker pid %d overstayed the %.1fs drain window; "
                    "escalating to SIGKILL", p.pid, self.drain_timeout_s,
                )
                self.kills_escalated += 1
                p.kill()
                still.append((p, float("inf")))  # never escalate twice
                continue
            still.append((p, deadline))
        self._draining = still

    def _reap(self, component: str) -> list[subprocess.Popen]:
        self._reap_draining()
        procs = self._procs.setdefault(component, [])
        live = []
        for p in procs:
            rc = p.poll()
            if rc is None:
                live.append(p)
            else:
                self.exit_codes.append((p.pid, rc))
        dead = len(procs) - len(live)
        if dead:
            log.warning("%d dead %s worker(s) reaped", dead, component)
        self._procs[component] = live
        return live

    def current(self, component: str) -> int:
        return len(self._reap(component))

    def draining_count(self) -> int:
        """Scaled-down workers still inside their drain window."""
        self._reap_draining()
        return len(self._draining)

    async def set_replicas(self, component: str, replicas: int) -> None:
        argv = self.worker_argv.get(component)
        if argv is None:
            log.warning("no worker command for component %r", component)
            return
        procs = self._reap(component)
        while len(procs) < replicas:
            env = dict(os.environ, DYN_STORE_ADDRESS=self.store_address, **self.env)
            p = subprocess.Popen(
                [sys.executable, *argv],
                env=env,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            procs.append(p)
            log.info("scaled up %s -> %d (pid %d)", component, len(procs), p.pid)
        while len(procs) > replicas:
            p = procs.pop()
            # Graceful drain, never a kill: the worker's SIGTERM handler
            # deregisters, finishes in-flight streams, and exits. The
            # signal is non-blocking here; escalation and exit-code
            # collection happen on subsequent reap cycles.
            p.send_signal(signal.SIGTERM)
            self._draining.append(
                (p, time.monotonic() + self.drain_timeout_s)
            )
            log.info(
                "scaled down %s -> %d (pid %d draining, %.1fs window)",
                component, len(procs), p.pid, self.drain_timeout_s,
            )

    def shutdown(self) -> None:
        for procs in self._procs.values():
            for p in procs:
                if p.poll() is None:
                    p.terminate()
        pending = [p for procs in self._procs.values() for p in procs]
        pending += [p for p, _ in self._draining]
        for p in pending:
            try:
                rc = p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            self.exit_codes.append((p.pid, rc))
        self._procs.clear()
        self._draining.clear()

"""Automated recovery verification after a chaos run.

After the fault plan is uninstalled the cluster must *heal*, and
"healed" is a checkable predicate, not a vibe:

  * every submitted task reaches a terminal state (FINISHED/FAILED) —
    nothing wedged in SUBMITTED/LEASED/RUNNING, and the driver's own
    pending-task table drains;
  * no wedged lease queues — every alive raylet's admission queue is
    empty once the workload quiesces;
  * the driver's reference table drains back to its pre-run baseline
    (chaos must not leak object refs);
  * no orphaned ErrorEvents — every fault-window error is either tagged
    ``chaos`` (extra.chaos=True / source "chaos") or one of the organic
    types the injected faults are *expected* to cause (task_failure from
    a killed worker, lease_orphan from a dropped lease reply, ...).

Reference inspiration: Jepsen's post-nemesis "final reads" phase and
FoundationDB's simulation invariant checks.

The port of ``ray_tpu/chaos/verifier.py``, on the port's worker, GCS and
``util.state``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable


# Organic error types an injected fault legitimately produces; anything
# else appearing during the fault window is an unexplained (orphaned)
# error and fails verification.
EXPECTED_ORGANIC_TYPES = frozenset({
    "task_failure", "actor_creation_failure", "replica_start_failure",
    "lease_orphan", "lease_wedge", "oom_kill", "memory_leak",
    # An injected preempt_slice rule drains a node: the GCS's
    # node_preempted notice is the designed consequence, not an orphan.
    "node_preempted",
})


@dataclass
class VerifyResult:
    ok: bool
    checks: dict = field(default_factory=dict)
    violations: list = field(default_factory=list)

    def raise_if_failed(self) -> "VerifyResult":
        if not self.ok:
            raise ChaosVerificationError(
                "recovery verification failed: " + "; ".join(self.violations))
        return self


class ChaosVerificationError(AssertionError):
    pass


def _is_actor_task_object(oid) -> bool:
    """True when the object is the return of an actor METHOD call or an
    actor creation: its TaskID embeds a non-nil ActorID unique part."""
    try:
        from ..core.ids import ActorID, TaskID

        tid = oid.task_id().binary()
        actor_unique = tid[TaskID.UNIQUE_BYTES:
                           TaskID.UNIQUE_BYTES + ActorID.UNIQUE_BYTES]
        return any(actor_unique)
    except Exception:
        return False


class RecoveryVerifier:
    """Asserts cluster invariants after a fault plan completes."""

    def __init__(self, timeout_s: float = 60.0, poll_s: float = 0.25,
                 allowed_error_types: Iterable[str] = ()):
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.allowed_error_types = (
            EXPECTED_ORGANIC_TYPES | frozenset(allowed_error_types))

    # ------------------------------------------------------------- baseline
    def snapshot_baseline(self) -> dict:
        """Capture pre-run state the post-run invariants are judged
        against (existing refs, the number of errors already buffered)."""
        from ..core.worker import global_worker

        w = global_worker()
        return {
            "ref_ids": {oid.hex() for oid in list(w.refcounter._refs)},
            "num_errors": self._error_count(),
        }

    @staticmethod
    def _error_count() -> int:
        from ..core.worker import global_worker

        reply = global_worker()._gcs_call("ListErrors", {"limit": 10000})
        return len(reply.get("errors") or [])

    # ----------------------------------------------------------------- wait
    def _wait_for(self, predicate, timeout: float):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            result = predicate()
            if result:
                return result
            time.sleep(self.poll_s)
        return predicate()

    # --------------------------------------------------------------- verify
    def verify(self, baseline: dict | None = None) -> VerifyResult:
        from ..core.worker import global_worker
        from ..util import state

        w = global_worker()
        checks: dict = {}
        violations: list[str] = []

        # 1. Every submitted task settles: the driver's pending table
        #    drains, and the GCS-side last-status per task is terminal.
        #    Actor METHOD calls are exempt — long-poll methods (serve
        #    routers, pub/sub listeners) are legitimately RUNNING forever;
        #    normal tasks and actor creations must settle.
        from ..core.task_spec import TASK_KIND_ACTOR_TASK

        def _pending_settleable() -> list[str]:
            tm = w.task_manager
            with tm._lock:
                return [e["spec"].name for e in tm._pending.values()
                        if e["spec"].kind != TASK_KIND_ACTOR_TASK]

        def _stuck_in_gcs() -> list[dict]:
            return [t for t in state.list_tasks(limit=100_000)
                    if t.get("state") in ("SUBMITTED", "LEASED", "RUNNING")
                    and t.get("kind", 0) != TASK_KIND_ACTOR_TASK]

        def _tasks_terminal():
            if _pending_settleable():
                return None
            return {"pending": 0} if not _stuck_in_gcs() else None

        settled = self._wait_for(_tasks_terminal, self.timeout_s)
        checks["tasks_terminal"] = bool(settled)
        if not settled:
            stuck = _stuck_in_gcs()
            violations.append(
                f"tasks not terminal: {_pending_settleable()[:5]} pending "
                f"on the driver, {len(stuck)} non-terminal in the GCS "
                f"(e.g. {[t.get('name') for t in stuck[:5]]})")

        # 2. No wedged lease queues on any alive raylet.
        def _queues_drained():
            diag = state.cluster_diagnostics(error_limit=0)
            depths = {n.get("node_id", "?")[:12]: n.get("lease_queue_depth", 0)
                      for n in diag["nodes"] if "unreachable" not in n}
            return depths if all(d == 0 for d in depths.values()) else None

        drained = self._wait_for(_queues_drained, self.timeout_s / 2)
        checks["lease_queues_drained"] = bool(drained)
        if not drained:
            diag = state.cluster_diagnostics(error_limit=0)
            depths = {n.get("node_id", "?")[:12]: n.get("lease_queue_depth", 0)
                      for n in diag["nodes"]}
            violations.append(f"lease queues not drained: {depths}")

        # 3. The driver's reference table returns to baseline (new refs
        #    created during the run must all have been released). Returns
        #    of actor METHOD calls are exempt: background long-polls
        #    (serve routers, pub/sub listeners) legitimately keep one
        #    in-flight return ref alive at any instant.
        base_ids = (baseline or {}).get("ref_ids", set())

        def _leaked() -> list[str]:
            return [oid.hex() for oid in list(w.refcounter._refs)
                    if oid.hex() not in base_ids
                    and not _is_actor_task_object(oid)]

        refs_ok = self._wait_for(lambda: (True if not _leaked() else None),
                                 self.timeout_s / 2)
        checks["refcounts_drained"] = bool(refs_ok)
        if not refs_ok:
            leaked = [h[:12] for h in _leaked()]
            violations.append(
                f"{len(leaked)} refs leaked past baseline: {leaked[:8]}")

        # 4. No orphaned ErrorEvents: everything that fired during the
        #    window is chaos-tagged or an expected organic consequence.
        events = state.list_errors(limit=10_000)
        window = events[(baseline or {}).get("num_errors", 0):]
        orphaned = [
            e for e in window
            if not (e.get("extra") or {}).get("chaos")
            and e.get("source") != "chaos"
            and e.get("type") not in self.allowed_error_types
        ]
        checks["no_orphaned_errors"] = {
            "window": len(window),
            "chaos_tagged": sum(
                1 for e in window
                if (e.get("extra") or {}).get("chaos")
                or e.get("source") == "chaos"),
            "orphaned": len(orphaned),
        }
        if orphaned:
            violations.append(
                "orphaned (non-chaos, unexpected) errors: "
                + ", ".join(f"{e.get('source')}/{e.get('type')}"
                            for e in orphaned[:5]))

        return VerifyResult(ok=not violations, checks=checks,
                            violations=violations)

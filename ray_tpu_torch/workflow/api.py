"""Workflow engine: step DAG -> checkpointed cluster execution.

Reference: ``python/ray/workflow/api.py`` (run/resume,
``workflow.continuation``), ``workflow_executor.py`` (step scheduling),
``workflow_storage.py`` (checkpoint layout), ``event_listener.py``
(event steps). Redesign: steps persist to a local/NFS directory as
pickled results keyed by deterministic step ids (DFS order + name); the
executor is a synchronous driver loop — workflow control flow does not
need an actor of its own at this scale, and crash recovery falls out of
storage alone.

Dynamic workflows: a step may return ``workflow.continuation(sub_dag)``
— the engine records the continuation durably, executes the sub-DAG in
the step's checkpoint namespace, and hands the SUB-DAG's result to the
step's parents; a crash between the step finishing and its continuation
completing resumes INSIDE the continuation (the step's own side effects
never re-run). Event steps (``workflow.wait_for_event``) park a step on
an ``EventListener`` whose poll blocks until the event arrives; the
received payload checkpoints like any result (exactly-once), and
``workflow.trigger_event`` feeds the built-in KV listener through the
cluster's GCS.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Callable

from .._vendor import cloudpickle

_DEFAULT_STORAGE = os.path.expanduser("~/.ray_tpu_torch_workflows")

STATUS_RUNNING = "RUNNING"
STATUS_SUCCESSFUL = "SUCCESSFUL"
STATUS_FAILED = "FAILED"


class StepNode:
    def __init__(self, fn: Callable, args: tuple, kwargs: dict, name: str | None = None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or getattr(fn, "__name__", "step")

    def options(self, name: str) -> "StepNode":
        return StepNode(self.fn, self.args, self.kwargs, name)


def step(fn: Callable):
    """``workflow.step(fn)(*args)`` builds a StepNode; args may contain
    other StepNodes (upstream dependencies)."""

    def bind(*args, **kwargs) -> StepNode:
        return StepNode(fn, args, kwargs)

    return bind


class Continuation:
    """Returned BY a step to dynamically extend the workflow: the engine
    executes ``dag`` (in the step's checkpoint namespace) and the sub-DAG's
    result becomes the step's result (reference ``workflow.continuation``).
    Continuations may return continuations (recursion)."""

    def __init__(self, dag: StepNode):
        if not isinstance(dag, StepNode):
            raise TypeError("continuation(...) takes a workflow step DAG")
        self.dag = dag


def continuation(dag: StepNode) -> Continuation:
    return Continuation(dag)


class EventListener:
    """Event-step provider (reference ``workflow/event_listener.py``):
    ``poll_for_event`` BLOCKS until the event arrives and returns its
    payload — which checkpoints as the step's result (exactly-once)."""

    def poll_for_event(self, *args, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError


class KVEventListener(EventListener):
    """Built-in listener on the cluster KV: blocks until someone calls
    ``workflow.trigger_event(key, payload)`` (any driver/worker/external
    process attached to the GCS)."""

    def __init__(self, poll_interval_s: float = 0.2):
        self.poll_interval_s = poll_interval_s

    # Set by the event step's driver (wall-clock deadline); the loop
    # raises on expiry so a failed/abandoned workflow can't leak an
    # immortal polling task (there is no task-cancel API yet).
    deadline: float | None = None

    def poll_for_event(self, key: str):
        from ..core.worker import global_worker

        w = global_worker()
        while True:
            reply = w._gcs_call("KvGet", {"key": f"wf_event:{key}"})
            if reply.get("found"):
                return pickle.loads(reply["value"])
            if self.deadline is not None and time.time() > self.deadline:
                raise TimeoutError(f"event {key!r} did not arrive in time")
            time.sleep(self.poll_interval_s)


def trigger_event(key: str, payload: Any = True) -> None:
    """Fire an event: every ``wait_for_event`` step listening on ``key``
    (across workflows) unblocks with ``payload``."""
    from ..core.worker import global_worker

    global_worker()._gcs_call(
        "KvPut", {"key": f"wf_event:{key}", "value": cloudpickle.dumps(payload),
                  "overwrite": True})


def _poll_event(listener_cls, args, kwargs, timeout_s):
    listener = listener_cls()
    if timeout_s is not None:
        listener.deadline = time.time() + timeout_s
    return listener.poll_for_event(*args, **kwargs)


def wait_for_event(listener_cls: type | str, *args, name: str | None = None,
                   timeout_s: float | None = 3600.0, **kwargs) -> StepNode:
    """An event step: completes when the listener's poll returns. Pass an
    ``EventListener`` subclass, or a string key as shorthand for the KV
    listener (``wait_for_event("deploy-approved")``). ``timeout_s`` bounds
    the listen (the step fails on expiry): without a task-cancel API, an
    unbounded listener whose workflow failed for other reasons would poll
    on a worker forever."""
    if isinstance(listener_cls, str):
        args = (listener_cls, *args)
        listener_cls = KVEventListener
    if not (isinstance(listener_cls, type) and issubclass(listener_cls, EventListener)):
        raise TypeError("wait_for_event needs an EventListener subclass or a key string")
    node = StepNode(_poll_event, (listener_cls, args, kwargs, timeout_s), {},
                    name=name or f"event-{getattr(listener_cls, '__name__', 'listener')}")
    return node


class _Storage:
    def __init__(self, base: str, workflow_id: str, create: bool = True):
        self.dir = os.path.join(base, workflow_id)
        if create:
            os.makedirs(self.dir, exist_ok=True)

    def _step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, f"step-{step_id}.pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self._step_path(step_id))

    def load_step(self, step_id: str):
        with open(self._step_path(step_id), "rb") as f:
            return pickle.load(f)

    def save_step(self, step_id: str, result: Any) -> None:
        tmp = self._step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(result, f)
        os.replace(tmp, self._step_path(step_id))  # atomic: no torn checkpoints

    def set_status(self, status: str, error: str = "") -> None:
        blob = {"status": status, "error": error, "ts": time.time()}
        tmp = os.path.join(self.dir, "status.json.tmp")
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, os.path.join(self.dir, "status.json"))

    def get_status(self) -> dict | None:
        try:
            with open(os.path.join(self.dir, "status.json")) as f:
                return json.load(f)
        except OSError:
            return None

    def save_dag(self, root: StepNode) -> None:
        path = os.path.join(self.dir, "dag.pkl")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                cloudpickle.dump(root, f)

    def load_dag(self) -> StepNode:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return pickle.load(f)


_WF_REF = "__wf_dep_ref__"


def _run_step(fn, args_spec, kwargs_spec, *dep_values):
    """Execute one step on a worker: dependency refs arrive as resolved
    VALUES (top-level args); placeholders in the specs splice them back
    into the original argument tree."""

    def fill(value):
        if isinstance(value, dict):
            if set(value) == {_WF_REF}:
                return dep_values[value[_WF_REF]]
            return {k: fill(v) for k, v in value.items()}
        if isinstance(value, list):
            return [fill(v) for v in value]
        if isinstance(value, tuple):
            return tuple(fill(v) for v in value)
        return value

    return fn(*[fill(a) for a in args_spec],
              **{k: fill(v) for k, v in kwargs_spec.items()})


def _execute(root: StepNode, storage: _Storage, step_timeout_s: float | None,
             prefix: str = "") -> Any:
    """Stepwise driver: every READY step (all deps resolved) is submitted
    as a task, so independent branches run CONCURRENTLY (reference
    ``workflow_executor.py:32``); results checkpoint as they complete.
    Step ids are assigned in deterministic DFS order, so a resumed run
    maps steps to the same checkpoints. A step returning a
    ``Continuation`` records it durably, executes the sub-DAG in its
    checkpoint namespace (``<step_id>:``), and exposes the sub-DAG's
    result to its parents."""
    from ..core import api as ray

    # ---- graph state (grows as continuations extend the DAG) -----------
    order: list[StepNode] = []
    node_deps: dict[int, list[StepNode]] = {}
    node_specs: dict[int, tuple] = {}
    step_ids: dict[int, str] = {}
    seen: set[int] = set()
    # Sub-DAG root -> the step whose continuation it is: resolving the
    # root resolves that step (iteratively — chains never recurse).
    cont_parent: dict[int, StepNode] = {}

    def build(node: StepNode, ns: str) -> None:
        """Assemble ``node``'s subtree into the scheduling state with ids
        in DFS order under namespace ``ns`` (stable across runs)."""
        if id(node) in seen:
            return
        seen.add(id(node))
        counter = _ns_counters.setdefault(ns, [0])
        deps: list[StepNode] = []

        def transform(value):
            if isinstance(value, StepNode):
                build(value, ns)
                deps.append(value)
                return {_WF_REF: len(deps) - 1}
            if isinstance(value, list):
                return [transform(v) for v in value]
            if isinstance(value, tuple):
                return tuple(transform(v) for v in value)
            if isinstance(value, dict):
                return {k: transform(v) for k, v in value.items()}
            return value

        args_spec = [transform(a) for a in node.args]
        kwargs_spec = {k: transform(v) for k, v in node.kwargs.items()}
        sid = f"{ns}{counter[0]:04d}-{node.name}"
        if len(sid) > 100:
            # Deep continuation chains concatenate namespaces per level;
            # fold long ids to a stable digest (same DAG -> same id, so
            # resume still maps to the same checkpoint files) before they
            # exceed filesystem name limits.
            import hashlib

            sid = (f"h{hashlib.sha1(sid.encode()).hexdigest()[:24]}"
                   f"-{node.name[:40]}")
        step_ids[id(node)] = sid
        counter[0] += 1
        node_deps[id(node)] = deps
        node_specs[id(node)] = (args_spec, kwargs_spec)
        order.append(node)

    _ns_counters: dict[str, list] = {}
    build(root, prefix)

    # ---- stepwise scheduling -------------------------------------------
    result_ref: dict[int, Any] = {}      # node -> final ObjectRef
    submitted: set[int] = set()
    pending: dict[Any, StepNode] = {}    # running task ref -> node

    def attach_continuation(node: StepNode, dag: StepNode) -> None:
        """Graft a step's continuation sub-DAG into the RUNNING driver
        loop: its steps schedule alongside every other ready step (sibling
        branches keep checkpointing — no nested executor), and resolving
        its root resolves ``node``."""
        build(dag, f"{step_ids[id(node)]}:c:")
        cont_parent[id(dag)] = node

    def finish(node: StepNode, value: Any) -> None:
        # Iterative: a FINAL value propagates up the continuation chain in
        # a loop; a Continuation grafts its sub-DAG and leaves `node`
        # unresolved until the sub-root finishes.
        while True:
            sid = step_ids[id(node)]
            if isinstance(value, Continuation):
                # Durable BEFORE execution: a crash mid-continuation
                # resumes inside the sub-DAG without re-running the step.
                if not storage.has_step(f"{sid}:cont"):
                    storage.save_step(f"{sid}:cont", value.dag)
                # Park the step on its continuation: without this,
                # maybe_submit's resume branch would graft a SECOND copy
                # of the sub-DAG on every pass (2^depth blowup).
                submitted.add(id(node))
                attach_continuation(node, value.dag)
                return
            storage.save_step(sid, value)
            result_ref[id(node)] = ray.put(value)
            parent = cont_parent.pop(id(node), None)
            if parent is None:
                return
            node = parent  # the chain's final value resolves each level

    def maybe_submit() -> None:
        for node in list(order):
            nid = id(node)
            if nid in result_ref or nid in submitted:
                continue
            sid = step_ids[nid]
            if storage.has_step(sid):
                finish(node, storage.load_step(sid))
                continue
            if storage.has_step(f"{sid}:cont"):
                # Crashed mid-continuation: graft the recorded sub-DAG;
                # the step body itself never re-runs.
                submitted.add(nid)  # parked on its continuation
                attach_continuation(node, storage.load_step(f"{sid}:cont"))
                continue
            deps = node_deps[nid]
            if any(id(d) not in result_ref for d in deps):
                continue  # not ready yet
            args_spec, kwargs_spec = node_specs[nid]
            opts = {"name": node.name}
            fn = node.fn
            if isinstance(fn, ray.RemoteFunction):
                # Preserve the step's remote options (num_gpus, resources,
                # retries...): the wrapper task must schedule exactly as
                # the user-configured remote function would.
                opts = {**fn._options, **opts}
                fn = fn._fn
            dep_refs = [result_ref[id(d)] for d in deps]
            ref = ray.remote(_run_step).options(**opts).remote(
                fn, args_spec, kwargs_spec, *dep_refs)
            pending[ref] = node
            submitted.add(nid)

    maybe_submit()
    while id(root) not in result_ref:
        # A continuation graft can make new steps ready (or finish steps
        # straight from checkpoints) without anything pending.
        if not pending:
            # Progress = anything resolved OR the graph growing (a resume
            # deep in a continuation chain grafts one level per pass, and
            # maybe_submit's order snapshot misses same-pass grafts).
            before = (len(result_ref), len(order))
            maybe_submit()
            if not pending and (len(result_ref), len(order)) == before:
                raise RuntimeError("workflow stalled: no runnable steps")  # pragma: no cover
            continue
        ready, _ = ray.wait(list(pending), num_returns=1, timeout=step_timeout_s)
        if not ready:
            raise TimeoutError(
                f"no workflow step completed within step_timeout_s={step_timeout_s}")
        ref = ready[0]
        node = pending.pop(ref)
        submitted.discard(id(node))
        finish(node, ray.get(ref, timeout=step_timeout_s))
        maybe_submit()
    return storage.load_step(step_ids[id(root)])


def run(dag: StepNode, *, workflow_id: str, storage: str | None = None,
        step_timeout_s: float | None = None) -> Any:
    """Run (or continue) a workflow to completion; returns the root step's
    result. Completed steps are skipped — side effects happen once.
    ``step_timeout_s`` bounds each step (default: unbounded — training
    steps legitimately run for hours)."""
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    st.save_dag(dag)
    st.set_status(STATUS_RUNNING)
    try:
        result = _execute(dag, st, step_timeout_s)
    except Exception as e:
        st.set_status(STATUS_FAILED, error=f"{type(e).__name__}: {e}")
        raise
    # Output BEFORE status: a crash between the two must never yield a
    # SUCCESSFUL workflow whose output is missing.
    st.save_step("__output__", result)
    st.set_status(STATUS_SUCCESSFUL)
    return result


def resume(workflow_id: str, *, storage: str | None = None,
           step_timeout_s: float | None = None) -> Any:
    """Continue a crashed/failed workflow from its persisted DAG and
    checkpoints (reference ``workflow.resume``)."""
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id, create=False)
    dag = st.load_dag()
    return run(dag, workflow_id=workflow_id, storage=storage,
               step_timeout_s=step_timeout_s)


def get_output(workflow_id: str, *, storage: str | None = None) -> Any:
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id, create=False)
    if not st.has_step("__output__"):
        raise ValueError(f"workflow {workflow_id} has no output (not finished?)")
    return st.load_step("__output__")


def get_status(workflow_id: str, *, storage: str | None = None) -> str | None:
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id, create=False)
    blob = st.get_status()
    return blob["status"] if blob else None


def list_all(*, storage: str | None = None) -> list[tuple[str, str]]:
    base = storage or _DEFAULT_STORAGE
    out = []
    try:
        entries = os.listdir(base)
    except OSError:
        return out
    for wf_id in sorted(entries):
        if not os.path.isdir(os.path.join(base, wf_id)):
            continue  # stray files in the storage dir are not workflows
        status = get_status(wf_id, storage=base)
        if status is not None:
            out.append((wf_id, status))
    return out

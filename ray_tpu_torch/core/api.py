"""Public API: init/shutdown, @remote, get/put/wait, actors.

Equivalent of the reference's ``python/ray/_private/worker.py`` (init:1285,
get:2642, put:2810, wait:2875, remote:3263), ``remote_function.py`` and
``actor.py`` (ActorClass:605, ActorHandle:1273).
"""

from __future__ import annotations

import functools
import inspect
import os
import threading
import time
from typing import Any, Callable, Sequence

from .ids import ActorID
from .object_ref import ObjectRef
from .status import RayTpuError
from .worker import CoreWorker, global_worker, set_global_worker

_init_lock = threading.Lock()
_node = None


def init(
    address: str | None = None,
    *,
    num_cpus: float | None = None,
    resources: dict | None = None,
    labels: dict | None = None,
    object_store_memory: int | None = None,
    ignore_reinit_error: bool = False,
    _system_config: dict | None = None,
) -> dict:
    """Start (or connect to) a cluster. Reference: worker.py:1285."""
    global _node
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                # Re-entrant init is only a no-op if the cluster this
                # process started is actually still ALIVE. A locally
                # hosted raylet can die underneath us (OOM-killed store,
                # crashed node harness): without this probe every later
                # init() no-ops against the corpse and each new worker
                # fails booting on the vanished shm store file.
                if _node is None or _local_cluster_alive(_node):
                    return {"address": _node.gcs_address if _node else address}
                if _node.gcs is None:
                    # Attached to a REMOTE cluster: rebooting would
                    # silently swap the user onto an isolated local
                    # cluster. Surface the death instead.
                    raise RayTpuError(
                        "local raylet attached to %s has died; call "
                        "ray_tpu.shutdown() then init(address=...) to "
                        "reattach" % _node.gcs_address)
                _shutdown_locked(tolerant=True)
            else:
                raise RayTpuError(
                    "ray_tpu.init() called twice; pass ignore_reinit_error=True")
        if _system_config:
            from .config import get_config

            get_config().apply_dict(_system_config)
        from .node import Node

        if address is None:
            # Submitted-job drivers connect to the running cluster via env
            # (reference: RAY_ADDRESS set by the job manager for entrypoints).
            address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        if address is not None and address.startswith("ray://"):
            # Ray Client mode: a REMOTE driver proxied through a cluster-
            # side ClientServer (reference util/client/__init__.py:200).
            raise NotImplementedError(
                "ray:// client addresses are not ported yet (ROADMAP queue A "
                "item 4: util.client)")
        if address is None:
            _node = Node(
                head=True,
                num_cpus=num_cpus,
                resources=resources,
                labels=labels,
                object_store_memory=object_store_memory,
            )
        else:
            # Connect to an existing cluster: start a local raylet joined to
            # the remote GCS (simplest driver attachment for the harness).
            _node = Node(
                head=False,
                gcs_address=address,
                num_cpus=num_cpus if num_cpus is not None else 0,
                resources=resources,
                labels=labels,
                object_store_memory=object_store_memory,
            )
        _node.connect_driver()
        return {"address": _node.gcs_address, "node_id": _node.raylet.node_id.hex()}


def is_initialized() -> bool:
    try:
        global_worker()
        return True
    except RayTpuError:
        return False


def _local_cluster_alive(node) -> bool:
    """Cheap liveness probe for the in-process cluster: the raylet's shm
    store segment must still exist (it vanishes when the store process
    dies or the node harness was torn down behind our back)."""
    try:
        return os.path.exists(node.raylet.store_path)
    except Exception:
        return False


def _shutdown_locked(tolerant: bool = False) -> None:
    """Shutdown body; caller holds ``_init_lock``. ``tolerant`` is for
    tearing down an already-dead cluster (the init liveness probe),
    where teardown steps are expected to fail; a user-called shutdown
    of a healthy cluster keeps errors loud."""
    global _node
    try:
        worker = global_worker()
        worker.shutdown()
    except RayTpuError:
        pass
    except Exception:
        if not tolerant:
            raise
    set_global_worker(None)
    if _node is not None:
        try:
            _node.shutdown()
        except Exception:
            if not tolerant:
                _node = None
                raise
        _node = None


def shutdown() -> None:
    with _init_lock:
        _shutdown_locked()


def put(value: Any) -> ObjectRef:
    return global_worker().put(value)


def get(refs, timeout: float | None = None):
    from ..observability import tracing

    single = isinstance(refs, ObjectRef)
    refs = [refs] if single else list(refs)
    ctx = tracing.current()
    if ctx is not None:
        # Inside an active trace: the get is a hop worth seeing (it is
        # where submit→lease→run latency surfaces to the caller).
        with tracing.span(f"get x{len(refs)}", kind="task",
                          attrs={"num_refs": len(refs)}):
            out = global_worker().get(refs, timeout)
    else:
        out = global_worker().get(refs, timeout)
    return out[0] if single else out


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1, timeout: float | None = None):
    return global_worker().wait(list(refs), num_returns, timeout)


def kill(actor: "ActorHandle") -> None:
    global_worker().kill_actor(actor._actor_id)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task producing ``ref`` (reference ``ray.cancel``):
    queued tasks are dropped and fail with TaskCancelledError; a running
    task is interrupted at its next Python bytecode; ``force=True`` kills
    the executing worker. Best-effort — a task that already finished is
    untouched; cancelled tasks are never retried."""
    global_worker().cancel(ref, force=force)


def get_actor(name: str) -> "ActorHandle":
    found = global_worker().get_actor_by_name(name)
    if found is None:
        raise ValueError(f"No actor named '{name}'")
    actor_id, _info = found
    return ActorHandle(actor_id)


def cluster_resources() -> dict:
    worker = global_worker()
    reply = worker._gcs_call("GetAllNodes", {})
    total: dict[str, float] = {}
    for node in reply["nodes"]:
        if node["state"] != "ALIVE":
            continue
        for k, v in node["resources"]["total"].items():
            total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> dict:
    worker = global_worker()
    reply = worker._gcs_call("GetAllNodes", {})
    total: dict[str, float] = {}
    for node in reply["nodes"]:
        # A draining node (preemption notice) is about to vanish: its
        # capacity must not count as available, or the elastic train
        # policy would size a group onto a node that dies mid-attempt.
        if node["state"] != "ALIVE" or node.get("draining"):
            continue
        for k, v in node["resources"]["available"].items():
            total[k] = total.get(k, 0.0) + v
    return total


def nodes() -> list:
    return global_worker()._gcs_call("GetAllNodes", {})["nodes"]


class RuntimeContext:
    """Reference: ``python/ray/runtime_context.py`` (get_runtime_context)."""

    @property
    def node_id(self) -> str:
        return global_worker().node_id

    @property
    def worker_id(self) -> str:
        return global_worker().worker_id

    @property
    def job_id(self) -> int:
        return global_worker().job_id.int_value()

    @property
    def actor_id(self) -> str | None:
        aid = global_worker().actor_id
        return aid.hex() if aid else None

    def get_node_id(self) -> str:
        return self.node_id


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()


def timeline(filename: str = "timeline.json") -> str:
    """Dump a chrome://tracing / Perfetto trace of task execution
    (reference ``ray.timeline``, ``python/ray/_private/state.py:965``)."""
    from .task_events import write_chrome_trace

    reply = global_worker()._gcs_call("Timeline", {})
    return write_chrome_trace(reply["trace"], filename)


# ----------------------------------------------------------------- @remote
_ABSENT = object()


class RemoteFunction:
    """Reference: remote_function.py (_remote:303)."""

    def __init__(self, fn: Callable, **options):
        self._fn = fn
        self._options = options
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def options(self, **new_options) -> "RemoteFunction":
        merged = {**self._options, **new_options}
        return RemoteFunction(self._fn, **merged)

    def _remote(self, args, kwargs, opts):
        worker = global_worker()
        resources = dict(opts.get("resources") or {})
        if opts.get("num_cpus") is not None:
            resources["CPU"] = opts["num_cpus"]
        if opts.get("num_gpus") is not None:
            resources["GPU"] = opts["num_gpus"]
        strategy = _strategy_to_wire(opts.get("scheduling_strategy"))
        pg_id, bundle = _placement_opts(opts)
        num_returns = opts.get("num_returns", 1)
        refs = worker.submit_task(
            self._fn,
            args,
            kwargs,
            name=opts.get("name") or self._fn.__name__,
            num_returns=num_returns,
            resources=resources,
            max_retries=opts.get("max_retries"),
            scheduling_strategy=strategy,
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle,
            runtime_env=opts.get("runtime_env"),
            generator_backpressure=opts.get("_generator_backpressure_num_objects") or 0,
        )
        if num_returns == "streaming":
            return refs  # ObjectRefGenerator
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._fn.__name__}' cannot be called directly; "
            f"use .remote()."
        )


class ActorMethod:
    """Reference: actor.py:116."""

    def __init__(self, handle: "ActorHandle", name: str, num_returns: int | str = 1,
                 generator_backpressure: int = 0, concurrency_group: str = ""):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._generator_backpressure = generator_backpressure
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        refs = global_worker().submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=self._num_returns,
            generator_backpressure=self._generator_backpressure,
            concurrency_group=self._concurrency_group,
        )
        if self._num_returns == "streaming":
            return refs  # ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns: int | str = 1,
                _generator_backpressure_num_objects: int = 0,
                concurrency_group: str = "") -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns,
                           _generator_backpressure_num_objects,
                           concurrency_group or self._concurrency_group)

    def bind(self, *args, **kwargs):
        """Build a compiled-graph node instead of submitting now
        (reference ``dag/class_node.py`` ClassMethodNode)."""
        from ..dag.nodes import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    """Reference: actor.py:1273. Pickles to the actor id; any process with
    the handle can call methods (per-caller sequencing actor-side). The
    owning process kills a non-detached, unnamed actor when its last local
    handle is garbage-collected."""

    def __init__(self, actor_id: bytes, _owned: bool = False):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_registered", False)
        try:
            global_worker().register_actor_handle(actor_id, _owned)
            object.__setattr__(self, "_registered", True)
        except RayTpuError:
            pass

    def __getattr__(self, item: str) -> ActorMethod:
        if item == "__ray_call__":
            # Internal: run a shipped function on the actor (compiled DAGs
            # install their executor loops through this).
            return ActorMethod(self, item)
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id,))

    def __del__(self):
        if getattr(self, "_registered", False):
            try:
                global_worker().deregister_actor_handle(self._actor_id)
            except Exception:
                pass

    def __repr__(self):
        return f"ActorHandle({ActorID(self._actor_id).hex()})"


class ActorClass:
    """Reference: actor.py:605."""

    def __init__(self, cls: type, **options):
        self._cls = cls
        self._options = options

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = global_worker()
        opts = self._options
        resources = dict(opts.get("resources") or {})
        if opts.get("num_gpus") is not None:
            resources["GPU"] = opts["num_gpus"]
        strategy = _strategy_to_wire(opts.get("scheduling_strategy"))
        pg_id, bundle = _placement_opts(opts)
        actor_id = worker.create_actor(
            self._cls,
            args,
            kwargs,
            name=opts.get("name", ""),
            num_cpus=opts.get("num_cpus"),
            resources=resources,
            max_restarts=opts.get("max_restarts", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            concurrency_groups=opts.get("concurrency_groups"),
            detached=opts.get("lifetime") == "detached",
            scheduling_strategy=strategy,
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle,
            runtime_env=opts.get("runtime_env"),
        )
        # Non-detached actors — named or not — die when the creator's last
        # handle is GC'd (reference actor.py: only lifetime="detached"
        # survives its creator).
        owned = opts.get("lifetime") != "detached"
        return ActorHandle(actor_id, _owned=owned)

    def options(self, **new_options) -> "ActorClass":
        return ActorClass(self._cls, **{**self._options, **new_options})


def _strategy_to_wire(strategy) -> dict:
    if strategy is None:
        return {}
    if isinstance(strategy, dict):
        return strategy
    return strategy.to_wire()


def _placement_opts(opts) -> tuple[bytes, int]:
    strategy = opts.get("scheduling_strategy")
    if strategy is not None and hasattr(strategy, "placement_group_id"):
        return strategy.placement_group_id, strategy.placement_group_bundle_index
    return b"", -1


def remote(*args, **options):
    """``@remote`` / ``@remote(num_cpus=..., ...)`` for functions and classes."""

    def wrap(target):
        if inspect.isclass(target):
            return ActorClass(target, **options)
        return RemoteFunction(target, **options)

    if len(args) == 1 and not options and (callable(args[0]) or inspect.isclass(args[0])):
        return wrap(args[0])
    return wrap


def method(num_returns: int = 1, concurrency_group: str = ""):
    """Per-method defaults on actor classes (reference actor.py
    ``@ray.method``): ``concurrency_group`` names the pool declared in
    ``@remote(concurrency_groups={...})`` this method runs in —
    resolved executor-side from the class definition, so handles need
    not know the class."""

    def decorator(fn):
        fn.__ray_num_returns__ = num_returns
        if concurrency_group:
            fn.__ray_concurrency_group__ = concurrency_group
        return fn

    return decorator

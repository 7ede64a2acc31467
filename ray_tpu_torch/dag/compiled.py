"""DAG compilation and the resident per-actor executor loop.

The port's own copy of ``ray_tpu/dag/compiled.py`` (reference
``python/ray/dag/compiled_dag_node.py:795``, CompiledDAG): compiling walks
the graph, allocates one channel per producing node, and installs a loop
on every participating actor via ``__ray_call__``. ``execute()`` is then a
channel write and a channel read, with no task submission at steady
state. Errors serialize through the channels and re-raise at the driver;
``teardown()`` closes the input channel, which cascades ChannelClosed
through every loop. Shm channels live in a ``raytpu_torch_dag_*``
directory under ``/dev/shm``.
"""

from __future__ import annotations

import os
import struct
import tempfile
import uuid

from ..core import serialization
from ..core.status import RayTaskError
from .channel import Channel, ChannelClosed, TcpChannelReader, TcpChannelServer
from .nodes import ClassMethodNode, DAGNode, InputNode, MultiOutputNode


def _open_reader(desc, capacity: int):
    """Open the reader end of a channel descriptor: ("shm", path) or
    ("tcp", address)."""
    if desc[0] == "tcp":
        return TcpChannelReader(desc[1])
    return Channel(desc[1], capacity)

# Channel payload = [u32 meta_len][meta][blob] using the core serializer,
# so DAG values get the same encoding (and error framing) as every other
# object in the system — one format, not two.
_LEN = struct.Struct("<I")


def _pack(value) -> bytes:
    meta, blob, _ = serialization.serialize(value)
    return _LEN.pack(len(meta)) + meta + bytes(blob)


def _pack_error(error: BaseException) -> bytes:
    meta, blob, _ = serialization.serialize_error(error)
    return _LEN.pack(len(meta)) + meta + bytes(blob)


def _unpack(payload: bytes):
    n = _LEN.unpack_from(payload)[0]
    meta = bytes(payload[_LEN.size : _LEN.size + n])
    value = serialization.deserialize(meta, payload[_LEN.size + n :])
    return value, meta == serialization.META_ERROR


def _probe_node(instance) -> str:
    """Phase-0 placement probe (runs on the actor)."""
    from ..core.worker import global_worker

    return global_worker().node_id


def _routable_host() -> str:
    """This process's routable host, derived from the worker address (which
    tracks the raylet's registered interface, not loopback)."""
    from ..core.worker import global_worker

    return global_worker().address.rpartition(":")[0] or "127.0.0.1"


def _create_out_server(instance) -> str:
    """Phase-1 for a cross-node producer: create the TCP channel server in
    the actor process (stashed on the instance for the phase-2 loop) and
    return its address."""
    host = _routable_host()
    server = TcpChannelServer(host=host, advertise=host)
    instance.__dict__["_dag_out_server"] = server
    return server.address


def _actor_loop(instance, method_name: str, in_specs: list, out_desc,
                capacity: int) -> str:
    """Runs ON the actor (shipped via __ray_call__): spin on input
    channels, apply the bound method, write the result. ``in_specs`` is a
    list of ("chan", desc) / ("const", value) in positional order, where
    desc is ("shm", path) or ("tcp", address)."""
    channels = {
        desc: _open_reader(desc, capacity) for kind, desc in in_specs if kind == "chan"
    }
    if out_desc[0] == "tcp":
        out = instance.__dict__.pop("_dag_out_server")
    else:
        # Readiness marker: compile() blocks until every loop has one, so
        # execute() timeouts never race actor-creation latency.
        with open(out_desc[1] + ".ready", "w") as f:
            f.write("1")
        out = Channel(out_desc[1], capacity)
    cursors = {desc: 0 for desc in channels}
    method = getattr(instance, method_name)
    try:
        while True:
            args, upstream_error = [], None
            for kind, item in in_specs:
                if kind == "const":
                    args.append(item)
                    continue
                payload, seq = channels[item].read(cursors[item])
                cursors[item] = seq
                value, is_error = _unpack(payload)
                if is_error and upstream_error is None:
                    upstream_error = value
                args.append(value)
            if upstream_error is not None:
                out.write(_pack_error(upstream_error))
                continue
            try:
                result = method(*args)
                payload = _pack(result)  # inside try: unpicklable results
                if len(payload) > capacity:
                    raise ValueError(
                        f"{method_name} result of {len(payload)} bytes exceeds "
                        f"channel capacity {capacity}; raise max_buffer_size"
                    )
            except Exception as e:  # serialize through the pipe, keep looping
                import traceback

                payload = _pack_error(RayTaskError(method_name, traceback.format_exc(), e))
            out.write(payload)
    except ChannelClosed:
        out.close_writer()  # cascade teardown downstream
        return "closed"
    finally:
        for ch in channels.values():
            ch.close()
        out.close()


class CompiledDAG:
    def __init__(self, output_node: DAGNode, max_buffer_size: int | None = None):
        from ..core.config import get_config

        self.capacity = max_buffer_size or get_config().dag_channel_capacity
        self._dir: str | None = None
        self._input_node: InputNode | None = None
        self._outputs: list[ClassMethodNode] = []
        self._loop_refs = []
        self._channels: dict[int, str] = {}  # id(node) -> channel path
        self._torn_down = False

        if isinstance(output_node, MultiOutputNode):
            self._outputs = list(output_node.outputs)
        else:
            self._outputs = [output_node]
        for out in self._outputs:
            if not isinstance(out, ClassMethodNode):
                raise TypeError("DAG outputs must be actor method nodes")

        # Validate the whole graph BEFORE allocating anything in /dev/shm —
        # a rejected compile must not leak RAM-backed files.
        order = self._toposort()
        if self._input_node is None:
            raise ValueError("compiled DAG needs an InputNode")
        # One node per actor: each node parks a never-returning executor
        # task on its actor, so a second node on the same actor could never
        # start (max_concurrency=1 sequencing) — reject early instead of
        # hanging compile.
        # Collective nodes materialize their hidden reducer actors now
        # (they must exist before placement probing / loop install).
        self._owned_actors = []
        for node in order:
            if hasattr(node, "materialize_actor"):
                node.materialize_actor()
                if getattr(node, "_owned_actor", False):
                    self._owned_actors.append(node.actor)
        seen_actors: dict[bytes, str] = {}
        for node in order:
            if not isinstance(node, ClassMethodNode):
                continue
            actor_id = node.actor._actor_id
            if actor_id in seen_actors:
                raise ValueError(
                    f"actor used by both '{seen_actors[actor_id]}' and "
                    f"'{node.method_name}' — a compiled DAG supports one node "
                    "per actor (create a separate actor per stage)"
                )
            seen_actors[actor_id] = node.method_name

        # Placement: each producer's channel is shm when every endpoint
        # shares its node, TCP otherwise (reference: shared_memory_channel
        # falls back to its cross-node transport per edge).
        from ..core import api as ray

        driver_node = ray.get_runtime_context().node_id
        node_of: dict[int, str] = {id(self._input_node): driver_node}
        for node in order:
            if isinstance(node, ClassMethodNode):
                node_of[id(node)] = ray.get(
                    node.actor.__ray_call__.remote(_probe_node), timeout=60)
        consumers: dict[int, list[str]] = {id(n): [] for n in order}
        for node in order:
            if isinstance(node, ClassMethodNode):
                for up in node.upstream():
                    consumers[id(up)].append(node_of[id(node)])
        for out in self._outputs:
            consumers[id(out)].append(driver_node)  # driver reads outputs

        self._dir = tempfile.mkdtemp(prefix="raytpu_torch_dag_", dir="/dev/shm")
        self._cross_node: set[int] = set()
        # One channel per producer (InputNode + every method node). The
        # descriptor is ("shm", path) or ("tcp", address).
        for node in order:
            local = all(c == node_of[id(node)] for c in consumers[id(node)])
            if local:
                path = os.path.join(self._dir, f"ch_{uuid.uuid4().hex[:10]}")
                Channel(path, self.capacity, create=True).close()
                self._channels[id(node)] = ("shm", path)
                continue
            self._cross_node.add(id(node))
            if node is self._input_node:
                # Advertise the driver's routable node host so consumer
                # actors on other hosts connect back to the driver rather
                # than their own loopback.
                host = _routable_host()
                self._input_server = TcpChannelServer(host=host, advertise=host)
                self._channels[id(node)] = ("tcp", self._input_server.address)
            else:
                # Phase 1: the producing actor creates its server NOW so
                # consumers know the address before their loops install.
                addr = ray.get(
                    node.actor.__ray_call__.remote(_create_out_server), timeout=60)
                self._channels[id(node)] = ("tcp", addr)

        in_desc = self._channels[id(self._input_node)]
        self._input = (self._input_server if in_desc[0] == "tcp"
                       else Channel(in_desc[1], self.capacity))
        self._out_channels = [
            _open_reader(self._channels[id(node)], self.capacity)
            for node in self._outputs
        ]
        self._out_cursors = [0] * len(self._outputs)

        # Phase 2: install executor loops (upstream-last so consumers are
        # listening before producers can emit).
        for node in order:
            if not isinstance(node, ClassMethodNode):
                continue
            in_specs = []
            for arg in node.args:
                if isinstance(arg, DAGNode):
                    in_specs.append(("chan", self._channels[id(arg)]))
                else:
                    in_specs.append(("const", arg))
            ref = node.actor.__ray_call__.remote(
                _actor_loop, node.method_name, in_specs,
                self._channels[id(node)], self.capacity,
            )
            self._loop_refs.append(ref)
        from ..core.config import get_config
        self._wait_ready(timeout=get_config().dag_ready_timeout_s)

    def _wait_ready(self, timeout: float) -> None:
        """Block until every executor loop has opened its channels, so
        execute() timeouts are about execution and loop-install failures
        (e.g. actor died) surface as real errors. Actor creation cannot be
        starved by task load anymore — the raylet admits actor-creation
        leases ahead of task leases (raylet._acquire_resources_queued) —
        so a miss here indicates a real failure, not scheduler unfairness."""
        import time

        from ..core import api as ray

        # Cross-node producers have no driver-visible marker file; their
        # phase-1 server creation already proved the actor alive, and the
        # loop-ref liveness check below covers install crashes.
        markers = [
            self._channels[id(node)][1] + ".ready"
            for node in self._channels_nodes()
            if self._channels[id(node)][0] == "shm"
        ]
        deadline = time.monotonic() + timeout
        while True:
            if all(os.path.exists(m) for m in markers):
                return
            # A loop ref completing at this stage means its install DIED.
            done, _ = ray.wait(list(self._loop_refs), num_returns=1, timeout=0)
            if done:
                ray.get(done[0])  # raises the real cause
                raise RuntimeError("DAG executor loop exited during compile")
            if time.monotonic() > deadline:
                missing = [m for m in markers if not os.path.exists(m)]
                raise TimeoutError(
                    f"{len(missing)} DAG executor loop(s) not ready after "
                    f"{timeout}s: {missing[:3]}"
                )
            time.sleep(0.01)

    def _channels_nodes(self) -> list[ClassMethodNode]:
        return [n for n in self._iter_nodes() if isinstance(n, ClassMethodNode)]

    def _iter_nodes(self):
        seen: set[int] = set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            yield node
            if isinstance(node, ClassMethodNode):
                for up in node.upstream():
                    yield from visit(up)

        for out in self._outputs:
            yield from visit(out)

    def _toposort(self) -> list[DAGNode]:
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(node: DAGNode) -> None:
            if id(node) in seen:
                return
            seen.add(id(node))
            if isinstance(node, InputNode):
                if self._input_node is not None and self._input_node is not node:
                    raise ValueError("a compiled DAG supports one InputNode")
                self._input_node = node
                order.append(node)
                return
            if isinstance(node, ClassMethodNode):
                if not node.upstream():
                    raise ValueError(
                        f"{node.method_name}.bind(...) has no upstream node — "
                        "a compiled node needs at least one DAG input or it "
                        "would loop forever"
                    )
                for up in node.upstream():
                    visit(up)
                order.append(node)
                return
            raise TypeError(f"unsupported DAG node {type(node).__name__}")

        for out in self._outputs:
            visit(out)
        return order

    # ---------------------------------------------------------------- execute
    def execute(self, value, timeout: float = 60.0):
        """Push one input through the graph; returns the output (or tuple
        of outputs for MultiOutputNode). Synchronous: one round at a time.

        ``timeout`` is ONE deadline for the whole round (not per output
        channel). A timed-out round poisons the pipeline — the parked
        executors may still be mid-compute, and their late results would
        desync every later round's cursors — so the DAG tears itself
        down: this call raises TimeoutError, and every subsequent
        ``execute`` raises ChannelClosed (never hangs, never returns a
        stale round)."""
        if self._torn_down:
            raise ChannelClosed("DAG has been torn down")
        import time as _time

        deadline = _time.monotonic() + timeout
        self._input.write(_pack(value))
        # Drain EVERY output before raising: skipping channels on error
        # would leave their cursors one round behind and desync all later
        # executes (they would read this round's stale payloads).
        results, first_error = [], None
        for i, ch in enumerate(self._out_channels):
            try:
                payload, seq = ch.read(
                    self._out_cursors[i],
                    timeout=max(0.0, deadline - _time.monotonic()))
            except TimeoutError:
                # Surface a dead loop's real error instead of the timeout.
                from ..core import api as ray

                done, _ = ray.wait(list(self._loop_refs), num_returns=1, timeout=0)
                try:
                    if done:
                        ray.get(done[0])
                    raise
                finally:
                    # Tear down rather than leave a desynced pipeline: the
                    # executor blocked on this round would complete it
                    # AFTER our cursors moved on.
                    self.teardown(timeout=1.0)
            self._out_cursors[i] = seq
            result, is_error = _unpack(payload)
            if is_error and first_error is None:
                first_error = result
            results.append(result)
        if first_error is not None:
            raise (first_error.as_instanceof_cause()
                   if isinstance(first_error, RayTaskError) else first_error)
        return results[0] if len(results) == 1 else tuple(results)

    # --------------------------------------------------------------- teardown
    def teardown(self, timeout: float = 30.0) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        # Defensive getattr: __del__ may run on a DAG whose __init__ raised
        # partway (validation errors) — clean what exists.
        input_ch = getattr(self, "_input", None)
        if input_ch is not None:
            input_ch.close_writer()  # ChannelClosed cascades through loops
            from ..core import api as ray

            try:
                ray.get(self._loop_refs, timeout=timeout)
            except Exception:
                pass
            input_ch.close()
        for ch in getattr(self, "_out_channels", []):
            ch.close()
        for actor in getattr(self, "_owned_actors", []):
            try:
                from ..core import api as ray

                ray.kill(actor)
            except Exception:
                pass
        if self._dir is not None:
            import shutil

            shutil.rmtree(self._dir, ignore_errors=True)

    def __del__(self):
        try:
            self.teardown(timeout=1.0)
        except Exception:
            pass

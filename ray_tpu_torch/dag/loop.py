"""Persistent compiled loops: the streaming sibling of ``CompiledDAG``.

The port's own copy of ``ray_tpu/dag/loop.py``. ``CompiledDAG.execute()``
is one-shot: each call pushes ONE input and synchronously drains ONE
output round. A steady-state iteration loop (a training step loop, a
decode tick path) wants the other half of the reference's compiled-graph
design: negotiate resources ONCE, then stream iterations over dedicated
channels with NO task submission, RPC or lease traffic per tick.

``compile_loop(graph)`` installs a never-returning tick executor on each
stage actor (one ``__ray_call__`` submission per stage, the only tasks
the loop ever submits), wires the stages with credit-based streaming
channels (``RingChannel`` shm rings on one node, ``TcpLoopServer``
across nodes), and returns a :class:`CompiledLoop`:

  * ``loop.put(x)`` enqueues an iteration input; it blocks only when the
    pipeline is ``credits`` iterations deep (backpressure propagates hop
    by hop through the ring credits, with no control RPCs).
  * ``loop.get()`` returns the next iteration's output(s), in order,
    exactly once. ``put``/``get`` may run from different threads;
    ``run(x)`` is the synchronous convenience.
  * ``loop.teardown()`` closes the input ring; ``ChannelClosed`` cascades
    stage to stage as in the one-shot DAG, and in-flight iterations
    drain first (close-after-drain STOP semantics).

Differences from the one-shot DAG worth knowing:

  * Channels DELIVER EVERY MESSAGE (bounded ring), not latest-wins: an
    iteration can never be overwritten by the next one.
  * Stage errors serialize through the pipe per iteration: the loop
    survives, the failing iteration's ``get()`` re-raises.
  * Stage workers are LEASE-PINNED: the raylet is told these workers
    park a resident loop, so the orphan-lease watchdog never reclaims
    them as stranded grants (``PinLoopWorker``).
  * Observability: every stage counts ``ray_tpu_dag_loop_ticks_total``
    and gauges its output-channel occupancy; one ``dag.loop.tick`` span
    per ``dag_loop_span_every`` ticks rides the normal span flush, and so
    do the stall aggregates (``observability/loop_recorder.py``).

Rings are sparse files of ``credits`` slots of ``max_buffer_size`` bytes
in a ``raytpu_torch_dag_*`` directory under ``/dev/shm``: a message takes
the pages it writes, and a slot must hold the largest packed message.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import uuid
import weakref

from .channel import (ChannelClosed, RingChannel, TcpLoopReader,
                      TcpLoopServer)
from .compiled import _pack, _pack_error, _probe_node, _routable_host, _unpack
from .nodes import ClassMethodNode, DAGNode, InputNode, MultiOutputNode


def _open_loop_reader(spec):
    """Open the reader end of an input spec ("ring", path, slots, readers,
    index) or ("tcp", address)."""
    if spec[0] == "tcp":
        return TcpLoopReader(spec[1])
    _, path, slot_size, n_slots, _n_readers, index = spec
    return RingChannel(path, slot_size, n_slots, reader_index=index)


def _create_loop_out_server(instance, n_slots: int, n_readers: int) -> str:
    """Phase-1 for a cross-node loop producer: create the streaming TCP
    server in the actor process and return its address."""
    host = _routable_host()
    server = TcpLoopServer(n_slots, n_readers, host=host, advertise=host)
    instance.__dict__["_dag_loop_out_server"] = server
    return server.address


_tick_metrics = None


def _loop_metrics():
    """Per-process loop metrics, created lazily so loop-free processes
    never start the metrics flusher."""
    global _tick_metrics
    if _tick_metrics is None:
        from ..observability.loop_recorder import TICK_MS_BOUNDARIES
        from ..util.metrics import Counter, Gauge, Histogram

        _tick_metrics = (
            Counter("ray_tpu_dag_loop_ticks_total",
                    "Iterations executed by resident compiled-loop stages",
                    tag_keys=("loop", "stage")),
            Gauge("ray_tpu_dag_loop_channel_occupancy",
                  "Unconsumed iterations queued in a loop stage's output "
                  "channel (0..credits; credits = backpressure engaged)",
                  tag_keys=("loop", "stage")),
            Histogram("ray_tpu_dag_loop_tick_ms",
                      "Per-tick stall attribution of resident loop stages: "
                      "time waiting on upstream input (bucket=wait_up), "
                      "computing (bucket=compute), and waiting on "
                      "downstream credits (bucket=wait_down)",
                      boundaries=TICK_MS_BOUNDARIES,
                      tag_keys=("loop", "stage", "bucket")),
        )
    return _tick_metrics


# Snapshot-file writes (snapshot aggregation + JSON + atomic replace,
# ~1ms on slow container filesystems) are time-gated: amortized over the
# span cadence alone they were the recorder's dominant cost on fast
# loops. The first flush always writes so stats() sees a young loop.
_STALL_FILE_MIN_S = 0.5


def _flush_stall(ring, hist, stall_tags, stall_path: str | None,
                 force: bool = False) -> None:
    """Drain the stage's stall ring into the aggregated histogram and
    (node-locally) an atomically-replaced snapshot file the driver's
    ``CompiledLoop.stats()`` reads without any actor RPC. Runs on the
    span cadence, never per tick; never raises into the loop."""
    if ring is None:
        return
    try:
        rows = ring.drain()
        if rows:
            # one bulk observe per bucket — per-sample observe() calls
            # (lock + tag-key resolution each) made the flush the
            # dominant recorder cost at ~45µs/tick amortized
            hist.observe_many([r[0] for r in rows], tags=stall_tags[0])
            hist.observe_many([r[1] for r in rows], tags=stall_tags[1])
            hist.observe_many([r[2] for r in rows], tags=stall_tags[2])
        now = time.monotonic()
        if stall_path and (force or now - ring.last_file_ts
                           >= _STALL_FILE_MIN_S):
            ring.last_file_ts = now
            tmp = stall_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(ring.snapshot(), f)
            os.replace(tmp, stall_path)
    except Exception:
        pass  # observability must never break the loop


def _loop_tick(instance, method_name: str, in_specs: list, out_desc,
               loop_id: str, span_every: int, stage_label: str | None = None,
               stall_path: str | None = None, stall_record: bool = True,
               stall_ring: int = 256) -> str:
    """The resident tick executor (ships to the stage actor via
    ``__ray_call__`` and never returns until teardown): read one
    iteration's inputs, apply the bound method, stream the result out.
    Blocking anywhere in the channel protocol IS the backpressure —
    which is exactly what the stall ring attributes: per tick, the time
    blocked in upstream ``read()`` (wait_up) vs the bound method
    (compute) vs downstream ``write()`` credit waits (wait_down), into a
    fixed-size in-process ring. Aggregates leave the process only on the
    ``span_every`` flush cadence (histogram + node-local snapshot file);
    the tick path itself does no allocation and no RPC for it."""
    from ..core.rpc import get_chaos

    readers = {i: _open_loop_reader(spec) for i, (kind, spec)
               in enumerate(in_specs) if kind == "chan"}
    if out_desc[0] == "tcp":
        out = instance.__dict__.pop("_dag_loop_out_server")
    else:
        _, path, slot_size, n_slots, n_readers = out_desc
        out = RingChannel(path, slot_size, n_slots)
        with open(path + ".ready", "w") as f:
            f.write("1")  # compile blocks on this marker (see _wait_ready)
    method = getattr(instance, method_name)
    stage = stage_label or method_name
    ticks = 0
    counter, occupancy, tick_hist = _loop_metrics()
    tags = {"loop": loop_id, "stage": stage}
    ring = None
    stall_tags = None
    if stall_record:
        from ..observability import loop_recorder

        ring = loop_recorder.get_stall_ring(loop_id, stage, stall_ring)
        stall_tags = tuple({"loop": loop_id, "stage": stage, "bucket": b}
                           for b in loop_recorder.STALL_BUCKETS)
    # Stall aggregates ride the span cadence; with tick spans disabled
    # they still flush, at the default stride.
    flush_every = span_every or 64
    perf = time.perf_counter
    try:
        while True:
            args, upstream_error = [], None
            r0 = perf()
            for i, (kind, spec) in enumerate(in_specs):
                if kind == "const":
                    args.append(spec)
                    continue
                value, is_error = _unpack(readers[i].read())
                if is_error and upstream_error is None:
                    upstream_error = value
                args.append(value)
            c0 = perf()
            if get_chaos().take_kill_loop_tick():
                # Deterministic chaos: this stage dies mid-loop, exactly
                # between consuming its inputs and producing its output.
                os._exit(1)
            if upstream_error is not None:
                out.write(_pack_error(upstream_error))
                ticks += 1
                continue
            t0 = time.time()
            try:
                result = method(*args)
                payload = _pack(result)  # inside try: unpicklable results
            except Exception as e:
                import traceback

                from ..core.status import RayTaskError

                payload = _pack_error(
                    RayTaskError(method_name, traceback.format_exc(), e))
            c1 = perf()
            out.write(payload)
            w1 = perf()
            ticks += 1
            if ring is not None:
                ring.record((c0 - r0) * 1e3, (c1 - c0) * 1e3,
                            (w1 - c1) * 1e3)
            counter.inc(tags=tags)
            occupancy.set(out.occupancy(), tags=tags)
            if ticks % flush_every == 0:
                _flush_stall(ring, tick_hist, stall_tags, stall_path)
            if span_every and ticks % span_every == 0:
                from ..observability import tracing

                tracing.record_span(tracing.make_span(
                    "dag.loop.tick", "dag", t0, time.time(), loop_id,
                    attrs={"stage": stage, "tick": ticks,
                           "out_occupancy": out.occupancy()}))
    except ChannelClosed:
        # final flush is forced past the file-write gate: teardown's
        # final_stats snapshot must see the complete tick history
        _flush_stall(ring, tick_hist, stall_tags, stall_path, force=True)
        out.close_writer()  # cascade teardown downstream
        return "closed"
    finally:
        for r in readers.values():
            r.close()
        out.close()


class CompiledLoop:
    """A compiled, resident iteration pipeline over stage actors.

    Build with :func:`compile_loop` (or
    ``node.experimental_compile_loop()``). One ``put`` produces exactly
    one ``get``-able output round; rounds stream in order with at most
    ``credits`` iterations in flight.
    """

    def __init__(self, output_node: DAGNode, max_buffer_size: int | None = None,
                 credits: int | None = None):
        from ..core import api as ray
        from ..core.config import get_config

        cfg = get_config()
        self.capacity = max_buffer_size or cfg.dag_channel_capacity
        self.credits = max(2, credits or cfg.dag_loop_credits)
        self._span_every = cfg.dag_loop_span_every
        self._stall_record = bool(
            getattr(cfg, "dag_loop_stall_recording", True))
        self._stall_ring = int(getattr(cfg, "dag_loop_stall_ring", 256))
        self._dir: str | None = None
        self._input_node: InputNode | None = None
        self._outputs: list[ClassMethodNode] = []
        self._loop_refs = []
        self._torn_down = False
        self._broken: str | None = None
        self._puts = 0
        self._gets = 0
        self._resume: list | None = None  # partial round after a get timeout
        from ..observability import tracing

        self.loop_id = tracing.new_trace_id()

        if isinstance(output_node, MultiOutputNode):
            self._outputs = list(output_node.outputs)
        else:
            self._outputs = [output_node]
        for out in self._outputs:
            if not isinstance(out, ClassMethodNode):
                raise TypeError("loop outputs must be actor method nodes")
        if len({id(o) for o in self._outputs}) != len(self._outputs):
            raise ValueError("a node may appear only once in a loop's "
                             "outputs (duplicates would alias ring cursors)")

        order = self._toposort()
        if self._input_node is None:
            raise ValueError("a compiled loop needs an InputNode")
        seen_actors: dict[bytes, str] = {}
        self._stage_nodes: list[ClassMethodNode] = []
        for node in order:
            if not isinstance(node, ClassMethodNode):
                continue
            if hasattr(node, "materialize_actor"):
                node.materialize_actor()
            actor_id = node.actor._actor_id
            if actor_id in seen_actors:
                raise ValueError(
                    f"actor used by both '{seen_actors[actor_id]}' and "
                    f"'{node.method_name}' — a compiled loop supports one "
                    "node per actor (create a separate actor per stage)")
            seen_actors[actor_id] = node.method_name
            self._stage_nodes.append(node)
        # Stable per-stage labels for metrics/stats: the method name,
        # disambiguated when two actors run same-named stages.
        self._stage_labels: list[str] = []
        name_counts: dict[str, int] = {}
        for node in self._stage_nodes:
            k = name_counts.get(node.method_name, 0)
            name_counts[node.method_name] = k + 1
            self._stage_labels.append(
                node.method_name if k == 0 else f"{node.method_name}#{k}")

        # Consumers per producer, in deterministic order; one reader end
        # per (consumer, arg position) so a node consuming the same
        # upstream twice gets two independent cursors. The driver is the
        # final consumer of every output node.
        consumers: dict[int, list] = {id(n): [] for n in order}
        for node in order:
            if isinstance(node, ClassMethodNode):
                for pos, arg in enumerate(node.args):
                    if isinstance(arg, DAGNode):
                        consumers[id(arg)].append((node, pos))
        for out in self._outputs:
            consumers[id(out)].append(("driver", 0))

        driver_node = ray.get_runtime_context().node_id
        node_of: dict[int, str] = {id(self._input_node): driver_node}
        for node in self._stage_nodes:
            node_of[id(node)] = ray.get(
                node.actor.__ray_call__.remote(_probe_node), timeout=60)

        self._dir = tempfile.mkdtemp(prefix="raytpu_torch_dag_", dir="/dev/shm")
        # Producer -> writer descriptor + per-consumer reader specs.
        self._out_desc: dict[int, tuple] = {}
        self._reader_spec: dict[tuple, tuple] = {}  # (prod id, consumer idx)
        self._ring_paths: list[str] = []
        self._input_server = None
        for node in order:
            cons = consumers[id(node)]
            if not cons:
                continue
            n_readers = len(cons)
            # shm ring when every endpoint (producer + all consumers,
            # driver included) shares a node; streaming TCP otherwise.
            local = all(
                (driver_node if c[0] == "driver" else node_of[id(c[0])])
                == node_of[id(node)] for c in cons)
            if local:
                path = os.path.join(self._dir, f"lp_{uuid.uuid4().hex[:10]}")
                RingChannel(path, self.capacity, self.credits,
                            n_readers=n_readers, create=True).close()
                self._ring_paths.append(path)
                self._out_desc[id(node)] = (
                    "ring", path, self.capacity, self.credits, n_readers)
                for idx in range(n_readers):
                    self._reader_spec[(id(node), idx)] = (
                        "ring", path, self.capacity, self.credits,
                        n_readers, idx)
            elif node is self._input_node:
                host = _routable_host()
                self._input_server = TcpLoopServer(
                    self.credits, n_readers, host=host, advertise=host)
                self._out_desc[id(node)] = ("tcp", self._input_server.address)
                for idx in range(n_readers):
                    self._reader_spec[(id(node), idx)] = (
                        "tcp", self._input_server.address)
            else:
                addr = ray.get(node.actor.__ray_call__.remote(
                    _create_loop_out_server, self.credits, n_readers),
                    timeout=60)
                self._out_desc[id(node)] = ("tcp", addr)
                for idx in range(n_readers):
                    self._reader_spec[(id(node), idx)] = ("tcp", addr)

        # Driver ends: the input writer + one reader per output node.
        in_desc = self._out_desc[id(self._input_node)]
        if in_desc[0] == "tcp":
            self._input = self._input_server
        else:
            self._input = RingChannel(in_desc[1], self.capacity, self.credits)
        self._out_readers = []
        for node in self._outputs:
            idx = consumers[id(node)].index(("driver", 0))
            self._out_readers.append(
                _open_loop_reader(self._reader_spec[(id(node), idx)]))

        # Install the resident tick executors, upstream-last so consumers
        # are listening before producers can emit.
        self._actors = []
        self._actor_nodes: list[tuple[str, str]] = []  # (actor hex, node id)
        # Stage label -> node-local stall snapshot file (None for stages
        # on other nodes — those surface through the GCS metrics flush).
        self._stall_files: dict[str, str | None] = {}
        for i, node in enumerate(self._stage_nodes):
            self._actor_nodes.append(
                (node.actor._actor_id.hex(), node_of[id(node)]))
            in_specs = []
            for pos, arg in enumerate(node.args):
                if isinstance(arg, DAGNode):
                    idx = consumers[id(arg)].index((node, pos))
                    in_specs.append(
                        ("chan", self._reader_spec[(id(arg), idx)]))
                else:
                    in_specs.append(("const", arg))
            label = self._stage_labels[i]
            stall_path = (os.path.join(self._dir, f"stall_{i}.json")
                          if node_of[id(node)] == driver_node else None)
            self._stall_files[label] = stall_path
            ref = node.actor.__ray_call__.remote(
                _loop_tick, node.method_name, in_specs,
                self._out_desc[id(node)], self.loop_id, self._span_every,
                label, stall_path, self._stall_record, self._stall_ring)
            self._loop_refs.append(ref)
            self._actors.append(node.actor)
        self._wait_ready(timeout=cfg.dag_ready_timeout_s)
        # Lease-pin the stage workers: these actors now park a resident
        # loop task, and the orphan-lease watchdog must not mistake the
        # (idle-looking, never-returning) lease for a stranded grant.
        self._pinned = self._pin_workers(True)
        self.final_stats: dict | None = None  # captured at teardown
        _register_loop(self)

    # ------------------------------------------------------------- plumbing
    def _toposort(self) -> list[DAGNode]:
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(node: DAGNode) -> None:
            if id(node) in seen:
                return
            seen.add(id(node))
            if isinstance(node, InputNode):
                if self._input_node is not None and self._input_node is not node:
                    raise ValueError("a compiled loop supports one InputNode")
                self._input_node = node
                order.append(node)
                return
            if isinstance(node, ClassMethodNode):
                if not node.upstream():
                    raise ValueError(
                        f"{node.method_name}.bind(...) has no upstream node — "
                        "a loop stage needs at least one DAG input")
                for up in node.upstream():
                    visit(up)
                order.append(node)
                return
            raise TypeError(f"unsupported DAG node {type(node).__name__}")

        for out in self._outputs:
            visit(out)
        return order

    def _wait_ready(self, timeout: float) -> None:
        from ..core import api as ray

        markers = [desc[1] + ".ready"
                   for nid, desc in self._out_desc.items()
                   if desc[0] == "ring" and nid != id(self._input_node)]
        deadline = time.monotonic() + timeout
        while True:
            if all(os.path.exists(m) for m in markers):
                return
            done, _ = ray.wait(list(self._loop_refs), num_returns=1, timeout=0)
            if done:
                ray.get(done[0])
                raise RuntimeError("loop executor exited during compile")
            if time.monotonic() > deadline:
                missing = [m for m in markers if not os.path.exists(m)]
                raise TimeoutError(
                    f"{len(missing)} loop executor(s) not ready after "
                    f"{timeout}s: {missing[:3]}")
            time.sleep(0.01)

    def _pin_workers(self, pinned: bool) -> bool:
        try:
            from ..core.worker import global_worker

            w = global_worker()
            for actor_hex, node_id in self._actor_nodes:
                w.pin_loop_worker(actor_hex, pinned, node_id=node_id)
            return pinned
        except Exception:
            return False  # pinning is protective, never fatal

    def _check_stage_death(self) -> None:
        """A completed loop ref at steady state means its stage DIED (or
        its install failed): surface the real error and break the loop."""
        from ..core import api as ray

        done, _ = ray.wait(list(self._loop_refs), num_returns=1, timeout=0)
        if not done:
            return
        try:
            result = ray.get(done[0])
            if result == "closed":
                return  # normal cascade exit, not a death
            err: Exception = ChannelClosed(f"loop stage exited: {result!r}")
        except Exception as e:
            err = e
        self._break(f"stage died: {err}")
        raise err

    def _break(self, reason: str) -> None:
        """Force-teardown after a failure: unblock every parked stage by
        force-closing the shm rings (a dead stage's consumers would
        otherwise spin forever on a channel nobody will ever close)."""
        if self._broken is not None:
            return
        self._broken = reason
        if self._input is not None:
            self._input.force_close()
        for path in self._ring_paths:
            try:
                RingChannel(path, self.capacity, self.credits).force_close()
            except OSError:
                pass
        self._pin_workers(False)

    # ------------------------------------------------------------------- API
    @property
    def in_flight(self) -> int:
        """Iterations put but not yet fully consumed by ``get``."""
        return self._puts - self._gets

    def stats(self, fallback_gcs: bool = True) -> dict:
        """Observability snapshot of the resident pipeline: per-stage
        tick stall attribution plus put/get progress and a bottleneck
        classification. Reads the node-local snapshot files the stages
        flush on the span cadence — no actor RPC (a resident stage's
        actor is parked in ``_loop_tick`` and could never answer one).
        Stages on OTHER nodes have no local file; their aggregates are
        rebuilt from the GCS-flushed histogram when ``fallback_gcs``.
        Stage ``state`` is ``compute_bound`` / ``starved`` (wait_up
        dominant) / ``backpressured`` (wait_down dominant) / ``idle``;
        the loop's ``bottleneck`` is the stage with the highest compute
        share — everyone else is waiting on it."""
        from ..observability import loop_recorder

        stages: dict[str, dict] = {}
        unseen = []
        for label, path in self._stall_files.items():
            snap = None
            if path:
                try:
                    with open(path) as f:
                        snap = json.load(f)
                except Exception:
                    snap = None
            if snap is None:
                unseen.append(label)
                snap = {"ticks": 0, "overflowed": False, "totals_ms": {},
                        "frac": {}, "recent_mean_ms": {}}
            stages[label] = snap
        if unseen and fallback_gcs and self._stall_record:
            for label, snap in _stall_from_metrics(self.loop_id).items():
                if not stages.get(label, {}).get("ticks"):
                    stages[label] = snap
        for snap in stages.values():
            snap["state"] = loop_recorder.classify_stage(
                snap.get("frac"), snap.get("ticks", 0))
        return {
            "loop_id": self.loop_id,
            "stages": stages,
            "bottleneck": loop_recorder.classify_loop(stages),
            "recording": self._stall_record,
            "puts": self._puts,
            "gets": self._gets,
            "in_flight": self.in_flight,
            "credits": self.credits,
            "broken": self._broken,
            "torn_down": self._torn_down,
        }

    def put(self, value, timeout: float | None = 60.0) -> None:
        """Enqueue one iteration input. Blocks only when the pipeline
        already holds ``credits`` unconsumed iterations (backpressure)."""
        if self._torn_down or self._broken:
            raise ChannelClosed(self._broken or "loop torn down")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                self._input.write(_pack(value), timeout=0.25)
                self._puts += 1
                return
            except TimeoutError:
                self._check_stage_death()
                if deadline is not None and time.monotonic() > deadline:
                    raise

    def get(self, timeout: float | None = 60.0):
        """Next iteration's output (tuple for MultiOutputNode), in put
        order. Re-raises a stage's per-iteration error; the loop itself
        survives errors and keeps streaming."""
        if self._torn_down:
            raise ChannelClosed("loop torn down")
        if self._broken and self._resume is None:
            raise ChannelClosed(self._broken)
        deadline = None if timeout is None else time.monotonic() + timeout
        # Resume a round a previous timed-out get left half-read, so
        # output cursors never desync across rounds.
        results = self._resume if self._resume is not None else []
        self._resume = None
        first_error = None
        while len(results) < len(self._out_readers):
            reader = self._out_readers[len(results)]
            try:
                payload = reader.read(timeout=0.25)
            except TimeoutError:
                # Slicing the wait keeps stage-death detection prompt; a
                # transient timeout here is NOT a failed round yet.
                self._check_stage_death()
                if deadline is not None and time.monotonic() > deadline:
                    # Preserve the half-read round so the next get()
                    # resumes at the SAME reader — cursors never desync.
                    self._resume = results
                    raise TimeoutError(
                        f"loop output idle past {timeout}s "
                        f"({self.in_flight} iterations in flight)")
                continue
            except ChannelClosed:
                self._break("loop output channel closed")
                raise
            results.append(_unpack(payload))
        self._gets += 1
        values = []
        for value, is_error in results:
            if is_error and first_error is None:
                first_error = value
            values.append(value)
        if first_error is not None:
            from ..core.status import RayTaskError

            raise (first_error.as_instanceof_cause()
                   if isinstance(first_error, RayTaskError) else first_error)
        return values[0] if len(values) == 1 else tuple(values)

    def run(self, value, timeout: float | None = 60.0):
        """Synchronous convenience: one put + one get."""
        self.put(value, timeout=timeout)
        return self.get(timeout=timeout)

    # --------------------------------------------------------------- teardown
    def teardown(self, timeout: float = 30.0) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        from ..chaos import clock as chaos_clock
        from ..core import api as ray

        t0 = chaos_clock.now()
        input_ch = getattr(self, "_input", None)
        if input_ch is not None and self._broken is None:
            input_ch.close_writer(timeout=min(timeout, 5.0))
        try:
            ray.get(list(self._loop_refs), timeout=timeout)
        except Exception:
            # A stage died or is stuck on a dead peer's channel: force
            # the cascade through every ring so the rest exit.
            self._break("teardown")
            try:
                ray.get(list(self._loop_refs), timeout=timeout)
            except Exception:
                pass
        self._pin_workers(False)
        if input_ch is not None:
            input_ch.close()
        for r in getattr(self, "_out_readers", []):
            r.close()
        if self._dir is not None:
            try:
                # Last look at the stall files before they vanish — the
                # train runner reports this as its loop_stats.
                self.final_stats = self.stats(fallback_gcs=False)
            except Exception:
                pass
            import shutil

            shutil.rmtree(self._dir, ignore_errors=True)
        self.torn_down_in_s = chaos_clock.now() - t0

    def __del__(self):
        try:
            self.teardown(timeout=1.0)
        except Exception:
            pass


# Driver-local registry of live loops: CompiledLoop objects only exist
# in the process that compiled them, so `state.loop_stats()` / the
# dashboard's /api/loops answer from here (weak — teardown or GC drops
# the entry without bookkeeping).
_live_loops: "weakref.WeakValueDictionary[str, CompiledLoop]" = \
    weakref.WeakValueDictionary()


def _register_loop(loop: CompiledLoop) -> None:
    _live_loops[loop.loop_id] = loop


def live_loop_stats() -> list[dict]:
    """``stats()`` for every live (not torn down) compiled loop this
    driver process owns, newest first by loop id order of creation."""
    out = []
    for loop in list(_live_loops.values()):
        if loop._torn_down:
            continue
        try:
            out.append(loop.stats())
        except Exception:
            continue
    return out


def _stall_from_metrics(loop_id: str) -> dict[str, dict]:
    """Cross-node fallback for ``CompiledLoop.stats()``: rebuild a
    stage's stall aggregates from the GCS-aggregated
    ``ray_tpu_dag_loop_tick_ms`` histogram rows (remote stages flush it
    through the ordinary metrics flusher; there is no node-local file to
    read). Best-effort — returns {} without a cluster."""
    from ..observability.loop_recorder import STALL_BUCKETS

    try:
        from ..util.metrics import get_metrics

        rows = get_metrics()
    except Exception:
        return {}
    stages: dict[str, dict] = {}
    for m in rows:
        if m.get("name") != "ray_tpu_dag_loop_tick_ms":
            continue
        tags = m.get("tags") or {}
        if tags.get("loop") != loop_id:
            continue
        st = stages.setdefault(tags.get("stage", "?"), {
            "ticks": 0, "overflowed": False,
            "totals_ms": {b: 0.0 for b in STALL_BUCKETS},
            "frac": {}, "recent_mean_ms": {}})
        bucket = tags.get("bucket", "")
        if bucket in st["totals_ms"]:
            st["totals_ms"][bucket] += float(m.get("value") or 0.0)
            if bucket == "compute":
                st["ticks"] += int(m.get("count") or 0)
    for st in stages.values():
        total = sum(st["totals_ms"].values()) or 1.0
        st["frac"] = {b: round(v / total, 4)
                      for b, v in st["totals_ms"].items()}
    return stages


def compile_loop(output_node: DAGNode, max_buffer_size: int | None = None,
                 credits: int | None = None) -> CompiledLoop:
    """Compile a DAG built with ``actor.method.bind(...)`` into a
    persistent streaming loop (see module docstring)."""
    return CompiledLoop(output_node, max_buffer_size=max_buffer_size,
                        credits=credits)

"""DAG node types (reference ``python/ray/dag/dag_node.py`` family).

The port's own copy of ``ray_tpu/dag/nodes.py``: ``actor.method.bind(...)``
builds a ``ClassMethodNode``; a graph of them compiles into a one-shot
``CompiledDAG`` or a streaming ``CompiledLoop``.
"""

from __future__ import annotations

from typing import Any


class DAGNode:
    def experimental_compile(self, max_buffer_size: int = 1 << 20):
        from .compiled import CompiledDAG

        return CompiledDAG(self, max_buffer_size=max_buffer_size)

    def experimental_compile_loop(self, max_buffer_size: int | None = None,
                                  credits: int | None = None):
        """Compile into a persistent streaming loop (``dag/loop.py``):
        resident tick executors and credit-based streaming channels, for
        steady-state iteration (``put``/``get``) instead of one-shot
        ``execute``."""
        from .loop import CompiledLoop

        return CompiledLoop(self, max_buffer_size=max_buffer_size,
                            credits=credits)


class InputNode(DAGNode):
    """The driver-supplied input (``with InputNode() as inp:``)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        pass


class ClassMethodNode(DAGNode):
    def __init__(self, actor, method_name: str, args: tuple, kwargs: dict):
        if kwargs:
            raise ValueError("compiled DAGs support positional args only")
        self.actor = actor
        self.method_name = method_name
        self.args = args

    def upstream(self) -> list[DAGNode]:
        return [a for a in self.args if isinstance(a, DAGNode)]


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: list[DAGNode]):
        self.outputs = list(outputs)


def _reduce_add(values):
    import functools
    import operator

    return functools.reduce(operator.add, values)


class _DagReducer:
    """Hidden reducer actor backing an AllReduceNode."""

    _OPS = {
        "sum": lambda vs: _reduce_add(vs),
        "mean": lambda vs: _reduce_add(vs) / len(vs),
        "max": lambda vs: max(vs),
        "min": lambda vs: min(vs),
    }

    def __init__(self, op):
        self._fn = op if callable(op) else self._OPS[op]

    def reduce(self, *values):
        return self._fn(list(values))


class AllReduceNode(ClassMethodNode):
    """Collective node: reduces N upstream nodes' outputs into one value
    (reference ``python/ray/dag/collective_node.py``). This is the
    host-side DAG collective for results across actors, not a tensor
    collective on the card: it compiles to a hidden reducer actor wired
    into the channel graph like any other stage."""

    def __init__(self, nodes: list, op: str | Any = "sum"):
        if len(nodes) < 2:
            raise ValueError("allreduce needs at least two upstream nodes")
        if not callable(op) and op not in _DagReducer._OPS:
            raise ValueError(f"unknown allreduce op {op!r}")
        self.actor = None  # materialized at compile time
        self.method_name = "reduce"
        self.args = tuple(nodes)
        self._op = op

    def materialize_actor(self) -> None:
        if self.actor is None:
            from ..core import api as ray

            self.actor = ray.remote(_DagReducer).options(
                num_cpus=0.1).remote(self._op)
            self._owned_actor = True


class _Collective:
    """``collective.allreduce.bind([n1, n2], op=...)``."""

    class _AllReduce:
        @staticmethod
        def bind(nodes: list, op: str | Any = "sum") -> AllReduceNode:
            return AllReduceNode(nodes, op)

    allreduce = _AllReduce()


collective = _Collective()

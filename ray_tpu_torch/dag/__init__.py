"""Compiled graphs: pre-wired actor pipelines over mutable shm channels.

The port's own copy of ``ray_tpu/dag`` (reference
``python/ray/dag/compiled_dag_node.py:795`` and its mutable-object
channels): build a DAG with ``actor.method.bind(...)``, compile it once,
then ``execute()`` it repeatedly with NO task submission per call: each
actor runs a resident executor loop that spins on its input channels, so
a round at steady state is a channel write, the compute and a channel
read. ``compile_loop`` turns the same graph into a streaming pipeline
over bounded rings (``put``/``get``). The channels are seqlock'd and ring
mmaps in ``/dev/shm`` (``channel.py``), byte for byte the JAX package's.
Nothing here imports torch.
"""

from .channel import Channel, RingChannel
from .compiled import CompiledDAG
from .loop import CompiledLoop, compile_loop
from .nodes import AllReduceNode, ClassMethodNode, InputNode, MultiOutputNode, collective

__all__ = ["AllReduceNode", "Channel", "CompiledDAG", "CompiledLoop",
           "ClassMethodNode", "InputNode", "MultiOutputNode", "RingChannel",
           "collective", "compile_loop"]

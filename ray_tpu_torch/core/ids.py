"""Binary identifiers with embedded lineage.

TPU-native re-design of the reference's ID scheme
(``src/ray/common/id.h:109-341``): IDs are fixed-width byte strings where a
child ID embeds its parent's ID so lineage can be recovered from the ID alone:

  JobID   (4 bytes)   — per driver / job
  ActorID (16 bytes)  — 12 unique bytes + JobID
  TaskID  (24 bytes)  — 8 unique bytes + ActorID (nil actor for normal tasks)
  ObjectID(28 bytes)  — TaskID + 4-byte little-endian return/put index
  NodeID, WorkerID, PlacementGroupID (28/28/18 bytes) — random

Task IDs are generated deterministically from (parent task, counter) so that
lineage re-execution regenerates identical object IDs — the property the
reference relies on for reconstruction (``task_spec.h:257``).
"""

from __future__ import annotations

import hashlib
import os
import struct

_NIL = b"\xff"


class BaseID:
    SIZE: int = 28
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} must be {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = bytes(binary)
        self._hash = hash((type(self).__name__, self._bytes))

    @classmethod
    def nil(cls):
        return cls(_NIL * cls.SIZE)

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == _NIL * self.SIZE

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class UniqueID(BaseID):
    SIZE = 28


class NodeID(BaseID):
    SIZE = 28


class WorkerID(BaseID):
    SIZE = 28


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack("<I", value))

    def int_value(self) -> int:
        return struct.unpack("<I", self._bytes)[0]


class ActorID(BaseID):
    """12 unique bytes + 4-byte JobID (reference ``id.h:130``)."""

    SIZE = 16
    UNIQUE_BYTES = 12

    @classmethod
    def of(cls, job_id: JobID, parent_task_id: "TaskID", parent_task_counter: int) -> "ActorID":
        h = hashlib.sha1()
        h.update(parent_task_id.binary())
        h.update(struct.pack("<Q", parent_task_counter))
        return cls(h.digest()[: cls.UNIQUE_BYTES] + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.UNIQUE_BYTES :])


class TaskID(BaseID):
    """8 unique bytes + 16-byte ActorID (reference ``id.h:178``)."""

    SIZE = 24
    UNIQUE_BYTES = 8

    @classmethod
    def for_driver_task(cls, job_id: JobID) -> "TaskID":
        return cls(b"\x00" * cls.UNIQUE_BYTES + ActorID.nil().binary()[:12] + job_id.binary())

    @classmethod
    def for_normal_task(
        cls, job_id: JobID, parent_task_id: "TaskID", parent_task_counter: int
    ) -> "TaskID":
        h = hashlib.sha1()
        h.update(parent_task_id.binary())
        h.update(struct.pack("<Q", parent_task_counter))
        nil_actor = ActorID.nil().binary()[: ActorID.UNIQUE_BYTES]
        return cls(h.digest()[: cls.UNIQUE_BYTES] + nil_actor + job_id.binary())

    @classmethod
    def for_actor_creation_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(b"\x00" * cls.UNIQUE_BYTES + actor_id.binary())

    @classmethod
    def for_actor_task(
        cls,
        job_id: JobID,
        parent_task_id: "TaskID",
        parent_task_counter: int,
        actor_id: ActorID,
    ) -> "TaskID":
        h = hashlib.sha1()
        h.update(parent_task_id.binary())
        h.update(struct.pack("<Q", parent_task_counter))
        return cls(h.digest()[: cls.UNIQUE_BYTES] + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[self.UNIQUE_BYTES :])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    """TaskID + 4-byte index (reference ``id.h:264``).

    Index 1..N are task returns; put objects use a separate counter offset by
    ``PUT_INDEX_OFFSET`` so returns and puts never collide.
    """

    SIZE = 28
    PUT_INDEX_OFFSET = 1 << 24

    @classmethod
    def for_task_return(cls, task_id: TaskID, return_index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack("<I", return_index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack("<I", put_index + cls.PUT_INDEX_OFFSET))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def index(self) -> int:
        return struct.unpack("<I", self._bytes[TaskID.SIZE :])[0]

    def is_put(self) -> bool:
        return self.index() >= self.PUT_INDEX_OFFSET

    def job_id(self) -> JobID:
        return self.task_id().job_id()


class PlacementGroupID(BaseID):
    """14 unique bytes + JobID (reference ``id.h:341``)."""

    SIZE = 18
    UNIQUE_BYTES = 14

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(os.urandom(cls.UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.UNIQUE_BYTES :])

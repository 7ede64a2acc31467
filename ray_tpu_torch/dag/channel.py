"""Channels of the compiled graphs and the loop wire.

The port's own copy of ``ray_tpu/dag/channel.py``, byte layouts kept, so
a channel or ring written by one package reads in the other:

* ``Channel``: a mutable single-writer, latest-wins slot over an mmap'd
  ``/dev/shm`` file, seqlock'd (``CompiledDAG``'s one-shot edges).
* ``RingChannel``: a bounded single-writer, multi-reader ring over an
  mmap'd file, every message delivered exactly once per reader, the
  writer blocked while it runs ``n_slots`` ahead of the slowest reader
  (``CompiledLoop``'s edges and its backpressure).
* ``TcpChannelServer`` / ``TcpChannelReader``: ``Channel``'s semantics
  over TCP, for one-shot edges whose ends live on different nodes.
* ``TcpLoopServer`` / ``TcpLoopReader``: ``RingChannel``'s over TCP, the
  wire that the compiled loop's cross-node edges, KV-page migration
  (``llm/migration.py``) and the weight broadcast (``llm/weights.py``)
  stream over.

Every TCP server listens on loopback unless its caller names another
interface: the wire has no authentication. The compiled graphs bind
their cross-node servers to the worker's own routable address.
"""

from __future__ import annotations

import mmap
import os
import socket
import struct
import threading
import time

# TCP frames: a reader sends its cursor (``<Q``: the last sequence seen,
# or the messages consumed so far); the server answers ``<QI`` (sequence,
# length) and the payload, or the length ``STOP_LEN`` once the writer has
# closed and the reader is drained.
_FRAME = struct.Struct("<QI")
_REQ = struct.Struct("<Q")
STOP_LEN = 0xFFFFFFFF

# How long a writer waits for credit, and a receiver for the rest of a
# stream, before it gives up (the JAX package's ``kv_migration_timeout_s``,
# which bounds its weight broadcast too); how long a reader waits to
# connect.
WIRE_TIMEOUT_S = 60.0
CONNECT_TIMEOUT_S = 10.0


class ChannelClosed(Exception):
    pass


def _recv_exact(conn: socket.socket, n: int) -> bytearray | None:
    """``n`` bytes from ``conn``, or None when the peer closed first. One
    buffer filled in place and handed on uncopied: a migration chunk is
    megabytes."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


# ------------------------------------------------------------ shm channel
# Layout: [u64 seq][u64 len][payload ... capacity]. ``seq`` is odd WHILE a
# write is in progress (seqlock): a reader that sees an odd seq, or whose
# second seq read differs from the first, retries, so a torn read is
# impossible without any cross-process lock. A ``len`` of ``STOP`` tears
# the channel down (executor loops exit).

_HEADER = struct.Struct("<QQ")
STOP = 0xFFFFFFFFFFFFFFFF


def _open_shm(path: str, create: bool) -> int:
    if create:
        return os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    return os.open(path, os.O_RDWR)


class Channel:
    """Mutable single-writer, latest-wins channel over an mmap'd file."""

    def __init__(self, path: str, capacity: int, create: bool = False):
        self.path = path
        self.capacity = capacity
        total = _HEADER.size + capacity
        fd = _open_shm(path, create)
        if create:
            os.ftruncate(fd, total)
        self._fd = fd
        self._mm = mmap.mmap(fd, total)
        self._view = memoryview(self._mm)

    def write(self, payload: bytes) -> None:
        if len(payload) > self.capacity:
            raise ValueError(
                f"message of {len(payload)} bytes exceeds channel capacity "
                f"{self.capacity} (raise max_buffer_size at compile time)")
        seq, _ = _HEADER.unpack_from(self._view, 0)
        _HEADER.pack_into(self._view, 0, seq + 1, len(payload))  # odd: in progress
        self._view[_HEADER.size:_HEADER.size + len(payload)] = payload
        _HEADER.pack_into(self._view, 0, seq + 2, len(payload))  # even: committed

    def close_writer(self) -> None:
        # The STOP length lands while seq is still ODD and the commit
        # touches ONLY the seq word: a torn header can never pair the new
        # even seq with the stale length (which would re-consume the final
        # payload and skip the STOP forever). write() is safe with its
        # wider commit because its odd phase pre-writes the same length.
        seq, _length = _HEADER.unpack_from(self._view, 0)
        _HEADER.pack_into(self._view, 0, seq + 1, STOP)  # odd: STOP staged
        struct.pack_into("<Q", self._view, 0, seq + 2)   # commit seq alone

    def read(self, last_seq: int, timeout: float | None = None
             ) -> tuple[bytes, int]:
        """Block (spin) until a version newer than ``last_seq`` commits;
        returns (payload, seq). Raises ChannelClosed on teardown."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-5
        while True:
            seq, length = _HEADER.unpack_from(self._view, 0)
            if seq % 2 == 0 and seq > last_seq:
                if length == STOP:
                    raise ChannelClosed(self.path)
                payload = bytes(self._view[_HEADER.size:_HEADER.size + length])
                seq2, _ = _HEADER.unpack_from(self._view, 0)
                if seq2 == seq:
                    return payload, seq
                continue  # torn read: the writer advanced mid-copy
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"channel {self.path} idle past {timeout}s")
            time.sleep(delay)
            delay = min(delay * 2, 0.001)

    def close(self) -> None:
        try:
            self._view.release()
            self._mm.close()
            os.close(self._fd)
        except Exception:
            pass

    def unlink(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


# ------------------------------------------------------------- ring channel
# Layout:
#
#     [u64 write_seq][u64 n_readers][u64 cursor * n_readers]
#     [slot 0: u64 len + payload] ... [slot n_slots-1]
#
# Slot ``s`` holds message ``seq`` iff ``seq % n_slots == s``. A slot is
# rewritten only after every reader's cursor has passed it (the credit
# protocol), so no seqlock is needed: the writer fills the payload, then
# publishes by bumping ``write_seq``. A ``len`` of STOP closes the ring;
# readers drain every message queued before it, then raise ChannelClosed
# for ever after (close after drain: a loop's teardown lets its in-flight
# iterations finish).

_RING_HEAD = struct.Struct("<QQ")
_SLOT_HEAD = struct.Struct("<Q")


class RingChannel:
    """Single-writer multi-reader bounded ring over an mmap'd shm file.

    One process opens the writer end (``reader_index=None``); each
    consumer opens a reader end with its compile-assigned
    ``reader_index`` in ``[0, n_readers)``. ``write`` blocks while the
    ring is full (slowest reader ``n_slots`` behind).
    """

    def __init__(self, path: str, slot_size: int, n_slots: int,
                 n_readers: int = 1, create: bool = False,
                 reader_index: int | None = None):
        self.path = path
        self.slot_size = slot_size
        self.n_slots = n_slots
        self.reader_index = reader_index
        fd = _open_shm(path, create)
        if not create:
            # The reader-cursor table sizes the layout: always take the
            # count from the creator's header.
            n_readers = _RING_HEAD.unpack(os.pread(fd, _RING_HEAD.size, 0))[1]
        self.n_readers = n_readers
        self._cursor_off = _RING_HEAD.size
        self._slots_off = _RING_HEAD.size + 8 * n_readers
        total = self._slots_off + n_slots * (_SLOT_HEAD.size + slot_size)
        if create:
            os.ftruncate(fd, total)
        self._fd = fd
        self._mm = mmap.mmap(fd, total)
        self._view = memoryview(self._mm)
        if create:
            _RING_HEAD.pack_into(self._view, 0, 0, n_readers)

    def _write_seq(self) -> int:
        return _RING_HEAD.unpack_from(self._view, 0)[0]

    def _cursor(self, r: int) -> int:
        return struct.unpack_from("<Q", self._view, self._cursor_off + 8 * r)[0]

    def _min_cursor(self) -> int:
        return min(self._cursor(r) for r in range(self.n_readers))

    def _slot(self, seq: int) -> int:
        return self._slots_off + (seq % self.n_slots) * (
            _SLOT_HEAD.size + self.slot_size)

    def occupancy(self) -> int:
        """Messages written but not yet consumed by the slowest reader
        (the loop runtime's channel-fill gauge)."""
        return self._write_seq() - self._min_cursor()

    def write(self, payload: bytes, timeout: float | None = None) -> None:
        if len(payload) > self.slot_size:
            raise ValueError(
                f"message of {len(payload)} bytes exceeds ring slot size "
                f"{self.slot_size} (raise max_buffer_size at compile time)")
        seq = self._wait_for_credit(timeout)
        off = self._slot(seq)
        _SLOT_HEAD.pack_into(self._view, off, len(payload))
        self._view[off + _SLOT_HEAD.size:
                   off + _SLOT_HEAD.size + len(payload)] = payload
        _RING_HEAD.pack_into(self._view, 0, seq + 1, self.n_readers)

    def _wait_for_credit(self, timeout: float | None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-5
        while True:
            seq = self._write_seq()
            if seq - self._min_cursor() < self.n_slots:
                return seq
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ring {self.path} full past {timeout}s (no reader credit)")
            time.sleep(delay)
            delay = min(delay * 2, 0.001)

    def close_writer(self, timeout: float | None = 30.0) -> None:
        """Queue a STOP after everything already written (close after
        drain). Falls back to ``force_close`` if readers never free a slot
        within ``timeout`` (a dead consumer)."""
        try:
            seq = self._wait_for_credit(timeout)
        except TimeoutError:
            self.force_close()
            return
        _SLOT_HEAD.pack_into(self._view, self._slot(seq), STOP)
        _RING_HEAD.pack_into(self._view, 0, seq + 1, self.n_readers)

    def force_close(self) -> None:
        """Overwrite the OLDEST unconsumed slot with STOP, ignoring
        credits. Loses queued messages: teardown after a failure only
        (the writing stage died and the driver unblocks its consumers)."""
        seq = max(self._min_cursor(), self._write_seq() - self.n_slots + 1)
        _SLOT_HEAD.pack_into(self._view, self._slot(seq), STOP)
        if self._write_seq() <= seq:
            _RING_HEAD.pack_into(self._view, 0, seq + 1, self.n_readers)

    def read(self, timeout: float | None = None) -> bytes:
        """Next message for this reader end (exactly once, in order).
        Consuming it releases the slot back to the writer (the credit)."""
        r = self.reader_index
        if r is None:
            raise RuntimeError("this end of the ring is the writer")
        cur = self._cursor(r)
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-5
        while self._write_seq() <= cur:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ring {self.path} idle past {timeout}s")
            time.sleep(delay)
            delay = min(delay * 2, 0.001)
        off = self._slot(cur)
        (length,) = _SLOT_HEAD.unpack_from(self._view, off)
        if length == STOP:
            raise ChannelClosed(self.path)  # the cursor stays: STOP is sticky
        payload = bytes(self._view[off + _SLOT_HEAD.size:
                                   off + _SLOT_HEAD.size + length])
        struct.pack_into("<Q", self._view, self._cursor_off + 8 * r, cur + 1)
        return payload

    close = Channel.close
    unlink = Channel.unlink


# -------------------------------------------------------------- cross-node
# Latest-wins TCP channel with the shm Channel's seq semantics, for
# one-shot DAG edges whose ends live on different nodes.


class TcpChannelServer:
    """Writer end: holds the latest message; any number of readers long-
    poll for sequences newer than their cursor."""

    def __init__(self, host: str = "127.0.0.1", advertise: str | None = None):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        port = self._sock.getsockname()[1]
        self.address = f"{advertise or host}:{port}"
        self._cond = threading.Condition()
        self._seq = 0
        self._payload = b""
        self._stopped = False
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def write(self, payload: bytes) -> None:
        with self._cond:
            self._seq += 1
            self._payload = bytes(payload)
            self._cond.notify_all()

    def close_writer(self) -> None:
        with self._cond:
            self._stopped = True
            self._seq += 1
            self._cond.notify_all()

    def close(self) -> None:
        self._closed = True
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                req = _recv_exact(conn, _REQ.size)
                if req is None:
                    return
                (last_seq,) = _REQ.unpack(req)
                with self._cond:
                    while self._seq <= last_seq and not self._stopped:
                        if self._closed:
                            return
                        self._cond.wait(1.0)
                    # As on the shm channel, close_writer overrides the
                    # slot: once stopped, readers see STOP.
                    if self._stopped:
                        conn.sendall(_FRAME.pack(self._seq, STOP_LEN))
                        continue
                    seq, payload = self._seq, self._payload
                conn.sendall(_FRAME.pack(seq, len(payload)) + payload)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class TcpChannelReader:
    """Reader end: ``Channel.read``'s interface (blocking, cursor-based)."""

    def __init__(self, address: str):
        host, _, port = address.rpartition(":")
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=CONNECT_TIMEOUT_S)
        self._sock.settimeout(None)

    def read(self, last_seq: int, timeout: float | None = None
             ) -> tuple[bytearray, int]:
        self._sock.settimeout(timeout)
        try:
            self._sock.sendall(_REQ.pack(last_seq))
            head = _recv_exact(self._sock, _FRAME.size)
            if head is None:
                raise ChannelClosed("tcp channel writer gone")
            seq, length = _FRAME.unpack(head)
            if length == STOP_LEN:
                raise ChannelClosed("tcp channel stopped")
            payload = _recv_exact(self._sock, length)
            if payload is None:
                raise ChannelClosed("tcp channel writer gone")
            return payload, seq
        except socket.timeout:
            raise TimeoutError(f"tcp channel idle past {timeout}s")
        finally:
            self._sock.settimeout(None)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class TcpLoopServer:
    """Writer end of a loop channel."""

    def __init__(self, n_slots: int, n_readers: int = 1,
                 host: str = "127.0.0.1", advertise: str | None = None):
        self.n_slots = n_slots
        self.n_readers = n_readers
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        port = self._sock.getsockname()[1]
        self.address = f"{advertise or '127.0.0.1'}:{port}"
        self._cond = threading.Condition()
        self._seq = 0                        # messages written so far
        self._buffer: dict[int, bytes] = {}  # seq -> payload (last n_slots)
        self._acked: dict[int, int] = {}     # conn id -> messages consumed
        self._stopped = False
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _min_acked(self) -> int:
        # Readers that have not connected yet count as cursor 0: the
        # writer runs at most n_slots ahead of a late joiner.
        acked = list(self._acked.values())
        while len(acked) < self.n_readers:
            acked.append(0)
        return min(acked)

    def occupancy(self) -> int:
        """Messages written that the slowest expected reader has not
        consumed."""
        with self._cond:
            return self._seq - self._min_acked()

    def write(self, payload: bytes, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._seq - self._min_acked() >= self.n_slots:
                if self._closed:
                    raise ChannelClosed(self.address)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"loop channel {self.address} full past {timeout}s")
                self._cond.wait(0.05)
            self._buffer[self._seq] = bytes(payload)
            self._seq += 1
            self._buffer.pop(self._seq - self.n_slots - 1, None)
            self._cond.notify_all()

    def close_writer(self, timeout: float | None = None) -> None:
        """Close after drain: queued messages still reach every reader,
        then each sees ``ChannelClosed``. Never blocks (``timeout`` is
        ``RingChannel.close_writer``'s, for a caller holding either)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    force_close = close_writer  # queued messages still drain, then STOP

    def close(self) -> None:
        """Drop the channel at once (a dead writer): no reader connects
        any more, and a connected reader gets the messages written so far,
        then sees ``ChannelClosed``."""
        self._closed = True
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        cid = id(conn)
        try:
            while True:
                req = _recv_exact(conn, _REQ.size)
                if req is None:
                    return
                (cursor,) = _REQ.unpack(req)  # messages consumed so far
                with self._cond:
                    self._acked[cid] = max(self._acked.get(cid, 0), cursor)
                    self._cond.notify_all()
                    while self._seq <= cursor and not self._stopped:
                        if self._closed:
                            return
                        self._cond.wait(1.0)
                    if self._seq <= cursor and self._stopped:
                        conn.sendall(_FRAME.pack(cursor, STOP_LEN))
                        continue
                    payload = self._buffer.get(cursor)
                if payload is None:
                    # The reader fell behind the buffer window: closed.
                    conn.sendall(_FRAME.pack(cursor, STOP_LEN))
                    continue
                conn.sendall(_FRAME.pack(cursor, len(payload)) + payload)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class TcpLoopReader:
    """Reader end: blocking, exactly-once, in order."""

    def __init__(self, address: str):
        host, _, port = address.rpartition(":")
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=CONNECT_TIMEOUT_S)
        self._sock.settimeout(None)
        self._cursor = 0

    def read(self, timeout: float | None = None) -> bytearray:
        self._sock.settimeout(timeout)
        try:
            self._sock.sendall(_REQ.pack(self._cursor))
            head = _recv_exact(self._sock, _FRAME.size)
            if head is None:
                raise ChannelClosed("loop channel writer gone")
            _seq, length = _FRAME.unpack(head)
            if length == STOP_LEN:
                raise ChannelClosed("loop channel stopped")
            payload = _recv_exact(self._sock, length)
            if payload is None:
                raise ChannelClosed("loop channel writer gone")
            self._cursor += 1
            return payload
        except socket.timeout:
            raise TimeoutError(f"loop channel idle past {timeout}s")
        finally:
            self._sock.settimeout(None)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

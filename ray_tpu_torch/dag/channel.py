"""Streaming (exactly-once, credit-bounded) TCP channel.

The port's own copy of the cross-node loop channel of
``ray_tpu/dag/channel.py`` (``ChannelClosed``, ``TcpLoopServer``,
``TcpLoopReader``): the wire that KV-page migration (``llm/migration.py``)
and the weight broadcast (``llm/weights.py``) stream over. The server
buffers the last ``n_slots`` messages, and ``write`` blocks until the
slowest of the ``n_readers`` expected readers has consumed far enough;
``close_writer`` lets queued messages drain, then readers see
``ChannelClosed``. The server listens on loopback unless its caller
names another interface: the wire has no authentication, and every
caller in this package runs both ends on one host.

Frames: a reader sends its cursor (``<Q``, messages consumed so far); the
server answers ``<QI`` (sequence, length) and the payload, or the length
``STOP_LEN`` once the writer has closed and the reader is drained.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

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

    def close_writer(self) -> None:
        """Close after drain: queued messages still reach every reader,
        then each sees ``ChannelClosed``."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

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

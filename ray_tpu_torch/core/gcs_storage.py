"""GCS table persistence: snapshot file behind the in-memory tables.

Equivalent of the reference's GCS fault-tolerance storage
(``src/ray/gcs/store_client/redis_store_client.h:107``): cluster metadata
(KV, jobs, actors, named actors, placement groups) survives a GCS
restart. Redesign: instead of an external Redis, a local atomic-rename
snapshot (msgpack) flushed by a dirty-flag loop — the GCS is the only
writer, so a WAL buys nothing over cheap whole-table snapshots at this
metadata volume, and there is no external service to operate.
"""

from __future__ import annotations

import os
import tempfile

from .._vendor import msgpack


def pack_tables(tables: dict) -> bytes:
    return msgpack.packb(tables, use_bin_type=True)


def unpack_tables(blob: bytes) -> dict:
    return msgpack.unpackb(blob, raw=False, strict_map_key=False)


class MemoryStorage:
    """Default: nothing persists (reference in-memory GCS store)."""

    persistent = False

    def load(self) -> dict | None:
        return None

    def save_blob(self, blob: bytes) -> None:
        pass

    def close(self) -> None:
        pass


class FileStorage:
    persistent = True

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def load(self) -> dict | None:
        try:
            with open(self.path, "rb") as f:
                return unpack_tables(f.read())
        except (OSError, ValueError):
            return None

    def save_blob(self, blob: bytes) -> None:
        # Atomic rename: a crash mid-write never corrupts the snapshot.
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".",
                                   prefix=".gcs_snap_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def close(self) -> None:
        pass


def storage_from_config(session_dir: str):
    from .config import get_config

    cfg = get_config()
    if cfg.gcs_storage_backend == "file":
        return FileStorage(os.path.join(session_dir, "gcs_tables.msgpack"))
    return MemoryStorage()

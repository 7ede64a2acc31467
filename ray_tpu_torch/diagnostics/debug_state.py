"""debug_state.txt rendering + atomic writes.

Reference: the raylet's periodic ``DumpDebugState`` →
``<session>/logs/debug_state.txt`` (``src/ray/raylet/node_manager.cc``
RecordMetrics/DebugString). Snapshots are plain nested dicts; this module
renders them as the familiar indented key: value text and writes them
atomically so a reader never sees a torn file.
"""

from __future__ import annotations

import os
import time


def format_debug_state(title: str, snapshot: dict) -> str:
    lines = [f"{title} debug state, generated at {time.strftime('%Y-%m-%d %H:%M:%S')}:"]

    def emit(key: str, value, indent: int) -> None:
        pad = "  " * indent
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:")
            for k in sorted(value, key=str):
                emit(str(k), value[k], indent + 1)
        elif isinstance(value, (list, tuple)):
            lines.append(f"{pad}{key}: ({len(value)} entries)")
            for i, item in enumerate(value):
                emit(f"[{i}]", item, indent + 1)
        else:
            lines.append(f"{pad}{key}: {value}")

    for key in sorted(snapshot, key=str):
        emit(str(key), snapshot[key], 1)
    return "\n".join(lines) + "\n"


def write_debug_state(path: str, title: str, snapshot: dict) -> None:
    """Render + write atomically (rename over the previous dump)."""
    text = format_debug_state(title, snapshot)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass

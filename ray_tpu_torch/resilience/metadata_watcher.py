"""GCE metadata-server preemption watcher (ROADMAP item 10a).

GCE announces a spot/preemptible VM reclaim through the instance
metadata server: ``GET /computeMetadata/v1/instance/preempted`` (with
the ``Metadata-Flavor: Google`` header) flips from ``FALSE`` to ``TRUE``
roughly 30 seconds before the VM disappears. Polling that key on the
node itself and feeding the raylet's existing ``PreemptionNotice`` path
(``begin_draining``) turns a cloud reclaim into the same measured
drain → task-event flush → proactive-serve-eviction → replacement
pipeline the chaos ``preempt_slice`` rule exercises — with no RPC from
the control plane needed and no dependency on the autoscaler's slower
PREEMPTED-listing poll.

Enabled per-raylet via config: ``preempt_metadata_watch`` (off by
default — only GCE instances have a metadata server), with
``preempt_metadata_url`` / ``preempt_metadata_poll_s`` overridable for
tests (a fake HTTP endpoint) and exotic environments.
"""

from __future__ import annotations

import logging
import threading
import urllib.request

logger = logging.getLogger(__name__)

DEFAULT_METADATA_URL = ("http://metadata.google.internal/computeMetadata/"
                        "v1/instance/preempted")


class GceMetadataPreemptionWatcher:
    """Polls the instance metadata ``preempted`` key and fires
    ``on_preempted(reason)`` exactly once when it reads TRUE, then
    stops (the node is going away; there is nothing left to watch).

    Transport errors count in ``errors`` and never fire the callback —
    an unreachable metadata server must not drain a healthy node."""

    def __init__(self, on_preempted, url: str = DEFAULT_METADATA_URL,
                 poll_s: float = 1.0, timeout_s: float = 2.0):
        self._on_preempted = on_preempted
        self._url = url
        self._poll_s = max(0.05, poll_s)
        self._timeout_s = timeout_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fired = False
        self.polls = 0
        self.errors = 0

    def poll_once(self) -> bool:
        """One metadata read; True iff the instance is being reclaimed."""
        req = urllib.request.Request(
            self._url, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=self._timeout_s) as resp:
                body = resp.read().decode(errors="ignore").strip().upper()
        except Exception:
            self.errors += 1
            return False
        self.polls += 1
        return body == "TRUE"

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.poll_once():
                self.fired = True
                logger.warning(
                    "GCE metadata server reports this instance PREEMPTED "
                    "(%s): feeding the preemption-notice drain path",
                    self._url)
                try:
                    self._on_preempted("gce metadata: instance preempted")
                except Exception:
                    logger.exception("preemption callback failed")
                return  # one-shot: the VM is being reclaimed
            self._stop.wait(self._poll_s)

    def start(self) -> "GceMetadataPreemptionWatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="gce-preempt-watch")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

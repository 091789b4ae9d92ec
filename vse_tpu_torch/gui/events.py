"""Event bus: the RPC bridge's command stream over HTTP long-poll.

The reference bridges its extractor child process to the GUI with a
``multiprocessing.Queue`` carrying {FINISH, PROGRESS, LOG, MANAGE_PROCESS,
ERROR} commands plus a pump thread (reference
backend/tools/subtitle_extractor_remote_call.py:5-67). Here extraction is
in-process, so the bridge is a seq-numbered ring buffer: producers append
typed events, HTTP clients long-poll ``wait(since)`` and resume from any
sequence number (reconnects don't lose events while within the window).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional


class EventBus:
    def __init__(self, window: int = 2048):
        self._events: deque = deque(maxlen=window)
        self._seq = 0
        self._cond = threading.Condition()

    def emit(self, kind: str, **payload) -> int:
        """Append one event; returns its sequence number."""
        with self._cond:
            self._seq += 1
            evt = {"seq": self._seq, "ts": time.time(), "kind": kind, **payload}
            self._events.append(evt)
            self._cond.notify_all()
            return self._seq

    @property
    def seq(self) -> int:
        return self._seq

    def since(self, seq: int) -> List[Dict]:
        with self._cond:
            return [e for e in self._events if e["seq"] > seq]

    def wait(self, seq: int, timeout: Optional[float] = 25.0) -> List[Dict]:
        """Long-poll: block until an event newer than `seq` exists (or
        timeout), then return everything newer."""
        deadline = time.monotonic() + (timeout or 0)
        with self._cond:
            while self._seq <= seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)
            return [e for e in self._events if e["seq"] > seq]

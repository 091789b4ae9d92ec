"""Async subprocess runner: stdout/stderr pump + exit callback.

Reference parity: backend/tools/python_runner.py:8-127 runs ``python -u
sushi`` for the timeline-sync tab with reader threads per stream and an
exit callback into the GUI. Same shape here, used by the sync tab (and
available for any external tool).
"""

from __future__ import annotations

import subprocess
import threading
from typing import Callable, List, Optional


class AsyncRunner:
    def __init__(self, argv: List[str],
                 on_line: Optional[Callable[[str, str], None]] = None,
                 on_exit: Optional[Callable[[int], None]] = None):
        self.argv = argv
        self.on_line = on_line
        self.on_exit = on_exit
        self.proc: Optional[subprocess.Popen] = None
        self._threads: List[threading.Thread] = []

    def start(self) -> None:
        self.proc = subprocess.Popen(
            self.argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, bufsize=1,
        )
        for stream_name in ("stdout", "stderr"):
            t = threading.Thread(
                target=self._pump, args=(stream_name,), daemon=True
            )
            t.start()
            self._threads.append(t)
        threading.Thread(target=self._wait, daemon=True).start()

    def _pump(self, stream_name: str) -> None:
        stream = getattr(self.proc, stream_name)
        for line in iter(stream.readline, ""):
            if self.on_line:
                self.on_line(stream_name, line.rstrip("\n"))
        stream.close()

    def _wait(self) -> None:
        rc = self.proc.wait()
        for t in self._threads:
            t.join(timeout=5)
        if self.on_exit:
            self.on_exit(rc)

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def terminate(self) -> None:
        if self.running:
            self.proc.terminate()

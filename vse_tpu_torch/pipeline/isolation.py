"""Process-isolated extraction: one spawned child per video, with the
reference's stop escalation (the port of ``vse_tpu/pipeline/isolation.py``).

- Each video runs in a ``multiprocessing`` child started with the spawn
  context (reference ui/home_interface.py:453-456): a forked child would
  inherit the parent's CUDA state, which CUDA does not support, while a
  spawned one starts clean and builds its own engine on the device it is
  given. That device must be there: a child given ``cuda`` on a machine
  without CUDA raises, as every entry point does, and never falls back to
  the CPU.
- The child reports over a queue with the reference RPC bridge's commands
  (reference backend/tools/subtitle_extractor_remote_call.py:5-67).
- ``stop`` escalates: cooperative cancel, then terminate, then kill
  (reference backend/tools/process_manager.py:116-126); a registry kills
  every live child at interpreter exit (:22-41).

A crashed child surfaces as an error with its exit code (reference
ui/home_interface.py:368-374).
"""

from __future__ import annotations

import atexit
import dataclasses
import enum
import multiprocessing as mp
import threading
from typing import Callable, Dict, Optional, Tuple


class Command(enum.Enum):
    """Wire commands (reference subtitle_extractor_remote_call.py:5-12;
    PID stands for MANAGE_PROCESS, which only ever carried the pid)."""

    PID = "pid"
    PROGRESS = "progress"
    LOG = "log"
    FINISH = "finish"
    ERROR = "error"


def _child_main(video_path: str, area_tuple: Optional[Tuple[int, int, int, int]],
                output_path: Optional[str], config_kwargs: dict, device: str,
                q: "mp.Queue", cancel: "mp.Event") -> None:
    """Child entry: build an extractor on ``device``, wire its listeners to
    the queue, run, and report FINISH or ERROR."""
    import os

    q.put((Command.PID, os.getpid()))
    try:
        from vse_tpu_torch.core.config import VseConfig
        from vse_tpu_torch.core.subtitle_area import SubtitleArea
        from vse_tpu_torch.pipeline.extractor import SubtitleExtractor

        area = SubtitleArea(*area_tuple) if area_tuple else None
        ex = SubtitleExtractor(video_path, sub_area=area, config=VseConfig(**config_kwargs),
                               device=device)
        # an mp.Event answers is_set() as threading.Event does; the
        # extractor polls it between device batches
        ex.cancel = cancel
        if output_path:
            ex.subtitle_output_path = output_path
        ex.add_progress_listener(lambda fe, ocr: q.put((Command.PROGRESS, (fe, ocr))))
        ex.append_output = lambda *a: q.put((Command.LOG, " ".join(str(x) for x in a)))
        q.put((Command.FINISH, ex.run()))
    except BaseException as e:  # noqa: BLE001 — every failure must reach the parent
        q.put((Command.ERROR, f"{type(e).__name__}: {e}"))


class ProcessManager:
    """Registry of live extraction children; kills them all at exit
    (reference backend/tools/process_manager.py:22-41)."""

    _instance: Optional["ProcessManager"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._procs: Dict[int, mp.Process] = {}
        self._plock = threading.Lock()
        atexit.register(self.kill_all)

    @classmethod
    def instance(cls) -> "ProcessManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = ProcessManager()
        return cls._instance

    def register(self, proc: mp.Process) -> None:
        with self._plock:
            self._procs[proc.pid or id(proc)] = proc

    def unregister(self, proc: mp.Process) -> None:
        with self._plock:
            self._procs.pop(proc.pid or id(proc), None)

    def kill_all(self) -> None:
        """Terminate every registered child, then kill the survivors
        (reference process_manager.py:71-126)."""
        with self._plock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)


class ProcessRunner:
    """Run one video's extraction in a spawned child and pump its events to
    callbacks on a parent thread (reference
    subtitle_extractor_remote_call.py:33-63)."""

    def __init__(self, video_path: str, sub_area=None, output_path=None, config=None,
                 device: str = "cuda",
                 on_progress: Optional[Callable[[float, float], None]] = None,
                 on_log: Optional[Callable[[str], None]] = None,
                 _target: Callable = _child_main):
        self.video_path = video_path
        self.sub_area = sub_area
        self.output_path = output_path
        self.config = config
        self.device = str(device)
        self.on_progress = on_progress
        self.on_log = on_log
        self._target = _target
        self.srt_path: Optional[str] = None
        self.error: Optional[str] = None
        self.child_pid: Optional[int] = None
        self._proc: Optional[mp.Process] = None
        self._pump: Optional[threading.Thread] = None
        self._ctx = mp.get_context("spawn")  # reference main.py:1086
        self._cancel = self._ctx.Event()
        self._q = self._ctx.Queue()

    def start(self) -> None:
        area_tuple = None
        if self.sub_area is not None:
            a = self.sub_area
            area_tuple = (a.ymin, a.ymax, a.xmin, a.xmax)
        cfg_kwargs = {}
        if self.config is not None:
            cfg_kwargs = {k: (v.value if isinstance(v, enum.Enum) else v)
                          for k, v in dataclasses.asdict(self.config).items()}
        self._proc = self._ctx.Process(
            target=self._target,
            args=(self.video_path, area_tuple, self.output_path, cfg_kwargs, self.device,
                  self._q, self._cancel),
            daemon=True,
        )
        self._proc.start()
        ProcessManager.instance().register(self._proc)
        self._pump = threading.Thread(target=self._pump_events, daemon=True)
        self._pump.start()

    def _pump_events(self) -> None:
        while True:
            try:
                cmd, payload = self._q.get(timeout=0.5)
            except Exception:
                if self._proc is not None and not self._proc.is_alive():
                    break
                continue
            if cmd is Command.PID:
                self.child_pid = payload
            elif cmd is Command.PROGRESS and self.on_progress:
                # a raising callback must not stop the pump before FINISH
                try:
                    self.on_progress(*payload)
                except Exception:
                    pass
            elif cmd is Command.LOG and self.on_log:
                try:
                    self.on_log(payload)
                except Exception:
                    pass
            elif cmd is Command.FINISH:
                self.srt_path = payload
                break
            elif cmd is Command.ERROR:
                self.error = payload
                break

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the child; True once it has exited. A child that died
        without reporting surfaces as an error with its exit code."""
        assert self._proc is not None and self._pump is not None
        self._pump.join(timeout)
        if self._pump.is_alive():
            return False
        self._proc.join(timeout)
        if self._proc.is_alive():
            return False
        ProcessManager.instance().unregister(self._proc)
        if self.srt_path is None and self.error is None:
            self.error = f"child exited without result (exitcode {self._proc.exitcode})"
        return True

    def stop(self, grace: float = 3.0) -> None:
        """Cooperative cancel, then terminate, then kill (reference
        process_manager.py:116-126)."""
        self._cancel.set()
        proc = self._proc
        if proc is None:
            return
        proc.join(timeout=grace)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=grace)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=grace)
        ProcessManager.instance().unregister(proc)
        if self.error is None and self.srt_path is None:
            self.error = "stopped"

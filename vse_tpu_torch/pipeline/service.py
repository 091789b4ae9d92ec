"""Extraction service: a task queue with progress and log callbacks (the port
of ``vse_tpu/pipeline/service.py``).

One worker thread drains the queue. With ``isolation="thread"`` (the
default) every video runs in that thread on one shared ``OcrEngine``, so
the models load and their CUDA graphs are captured once for the whole
queue. With ``isolation="process"`` each video runs in a spawned child
(``pipeline/isolation.py``) that builds its own engine on the service's
device: a crash in one video cannot take the service down.
"""

from __future__ import annotations

import enum
import threading
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import torch

from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.device import resolve_device
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.video.decode import Video


class TaskStatus(enum.Enum):
    """Reference parity: ui/component/task_list_component.py:16-21."""

    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class ExtractionTask:
    # a video file, or an InMemoryVideo (thread isolation only)
    video_path: Video
    sub_area: Optional[SubtitleArea] = None
    output_path: Optional[str] = None
    status: TaskStatus = TaskStatus.PENDING
    progress: float = 0.0  # 0..100 overall (the two channels / 2)
    error: Optional[str] = None
    srt_path: Optional[str] = None


@dataclass
class Callbacks:
    """The reference RPC bridge's commands as plain callables (reference
    subtitle_extractor_remote_call.py)."""

    on_progress: Optional[Callable[[ExtractionTask, float, float], None]] = None
    on_log: Optional[Callable[[ExtractionTask, str], None]] = None
    on_finish: Optional[Callable[[ExtractionTask], None]] = None
    on_error: Optional[Callable[[ExtractionTask, str], None]] = None


class ExtractionService:
    """Sequential task-queue worker (the reference processes videos one at
    a time in a worker thread, ui/home_interface.py:320-393)."""

    def __init__(self, config: Optional[VseConfig] = None,
                 callbacks: Optional[Callbacks] = None,
                 isolation: str = "thread",
                 device: Union[str, torch.device] = "cuda"):
        if isolation not in ("thread", "process"):
            raise ValueError(f"isolation must be thread|process, got {isolation!r}")
        self.config = config or VseConfig()
        self.callbacks = callbacks or Callbacks()
        self.isolation = isolation
        # process isolation hands the device's name to each child, which
        # resolves it there; the parent touches no CUDA state for it
        self.device = resolve_device(device) if isolation == "thread" else str(device)
        self.tasks: List[ExtractionTask] = []
        self._engine: Optional[OcrEngine] = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._current_ex: Optional[SubtitleExtractor] = None
        self._current_runner = None  # a ProcessRunner under process isolation

    def add_task(self, video_path: Video, sub_area: Optional[SubtitleArea] = None,
                 output_path: Optional[str] = None) -> ExtractionTask:
        task = ExtractionTask(video_path, sub_area, output_path)
        with self._lock:
            self.tasks.append(task)
        return task

    def remove_task(self, task: ExtractionTask) -> bool:
        """Remove a task that is not processing."""
        with self._lock:
            if task in self.tasks and task.status != TaskStatus.PROCESSING:
                self.tasks.remove(task)
                return True
        return False

    def invalidate_engine(self) -> None:
        """Drop the shared engine (after a config change that selects other
        models: the language or the mode)."""
        self._engine = None

    @property
    def running(self) -> bool:
        return bool(self._worker and self._worker.is_alive())

    def run_all(self, block: bool = True) -> None:
        """Process the queue on one worker thread."""
        if self._worker and self._worker.is_alive():
            raise RuntimeError("service already running")
        self._stop.clear()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        if block:
            self._worker.join()

    def stop(self) -> None:
        """Cancel the current video (between device batches, or by the
        child's stop escalation) and drain no further tasks."""
        self._stop.set()
        ex = self._current_ex
        if ex is not None:
            ex.cancel.set()
        runner = self._current_runner
        if runner is not None:
            runner.stop()

    def _emit_log(self, task, msg):
        if self.callbacks.on_log:
            self.callbacks.on_log(task, msg)

    def _on_progress(self, task, fe, ocr):
        task.progress = (fe + ocr) / 2.0
        if self.callbacks.on_progress:
            self.callbacks.on_progress(task, fe, ocr)

    def _drain(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                task = next((t for t in self.tasks if t.status == TaskStatus.PENDING), None)
            if task is None:
                return
            task.status = TaskStatus.PROCESSING
            if self.isolation == "process":
                self._run_isolated(task)
                continue
            try:
                ex = SubtitleExtractor(task.video_path, sub_area=task.sub_area,
                                       config=self.config, engine=self._engine,
                                       device=self.device)
                self._current_ex = ex
                if task.output_path:
                    ex.subtitle_output_path = task.output_path
                ex.add_progress_listener(
                    lambda fe, ocr, task=task: self._on_progress(task, fe, ocr))
                ex.append_output = lambda *a, task=task: self._emit_log(
                    task, " ".join(str(x) for x in a))
                task.srt_path = ex.run()
                self._engine = ex.engine
                task.status = TaskStatus.COMPLETED
                if self.callbacks.on_finish:
                    self.callbacks.on_finish(task)
            except Exception as e:  # the task fails; the worker drains on
                task.status = TaskStatus.FAILED
                task.error = f"{e}\n{traceback.format_exc()}"
                if self.callbacks.on_error:
                    self.callbacks.on_error(task, str(e))
            finally:
                self._current_ex = None

    def _run_isolated(self, task: ExtractionTask) -> None:
        """One spawned child per video (reference ui/home_interface.py:
        453-456); FAILED on an error or a nonzero exit (reference
        :368-374)."""
        from vse_tpu_torch.pipeline.isolation import ProcessRunner

        runner = ProcessRunner(
            task.video_path, sub_area=task.sub_area, output_path=task.output_path,
            config=self.config, device=self.device,
            on_progress=lambda fe, ocr, task=task: self._on_progress(task, fe, ocr),
            on_log=lambda msg, task=task: self._emit_log(task, msg),
        )
        self._current_runner = runner
        # a spawn failure or a raising callback fails THIS task, and the
        # worker goes on draining
        try:
            runner.start()
            while not runner.join(timeout=0.5):
                pass
            if runner.srt_path is not None:
                task.srt_path = runner.srt_path
                task.status = TaskStatus.COMPLETED
                if self.callbacks.on_finish:
                    self.callbacks.on_finish(task)
            else:
                task.status = TaskStatus.FAILED
                task.error = runner.error or "unknown child failure"
                if self.callbacks.on_error:
                    self.callbacks.on_error(task, task.error)
        except Exception as e:
            task.status = TaskStatus.FAILED
            task.error = f"{e}\n{traceback.format_exc()}"
            if self.callbacks.on_error:
                try:
                    self.callbacks.on_error(task, str(e))
                except Exception:
                    pass
        finally:
            self._current_runner = None

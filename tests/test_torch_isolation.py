"""The port's process isolation (``vse_tpu_torch/pipeline/isolation.py``),
mirroring ``tests/test_isolation.py``: one spawned child per video, its
events pumped to callbacks, a crash surfaced with its exit code, the
terminate -> kill stop escalation, the cooperative stop, ``kill_all``; and
``ExtractionService(isolation="process")`` end to end on a tiny clip with
``device="cpu"`` handed to the child, whose SRT equals the in-thread
run's. A child given ``cuda`` where there is none fails; it does not fall
back to the CPU. On the CPU only: a child needs a video file, and the
card's machine is not promised a decoder."""

import os
import time

import numpy as np
import pytest

import _torch_isolation_helpers as helpers
from _torch_helpers import two_threads  # noqa: F401
from vse_tpu_torch.pipeline.isolation import ProcessManager, ProcessRunner


def _run(target, **kw):
    events = {"progress": [], "logs": []}
    r = ProcessRunner("/tmp/fake.mp4", device="cpu",
                      on_progress=lambda fe, ocr: events["progress"].append((fe, ocr)),
                      on_log=events["logs"].append, _target=target, **kw)
    r.start()
    return r, events


def _wait_pid(r):
    deadline = time.time() + 30
    while r.child_pid is None and time.time() < deadline:
        time.sleep(0.05)


def test_finish_and_events():
    r, events = _run(helpers.child_ok, output_path="/tmp/x.srt")
    assert r.join(timeout=60)
    assert r.srt_path == "/tmp/x.srt" and r.error is None
    assert events["progress"] == [(50.0, 10.0)]
    assert events["logs"] == ["hello from child on cpu"]
    assert r.child_pid and r.child_pid != os.getpid()
    assert r._ctx.get_start_method() == "spawn"


def test_crash_surfaces_exitcode():
    r, _ = _run(helpers.child_crash)
    assert r.join(timeout=60)
    assert r.srt_path is None
    assert "exitcode 3" in r.error


def test_stop_escalates_to_kill():
    r, _ = _run(helpers.child_hang)
    _wait_pid(r)
    t0 = time.time()
    r.stop(grace=1.0)
    assert not r._proc.is_alive()
    assert time.time() - t0 < 8
    assert r.error == "stopped"


def test_stop_cooperative_path():
    r, _ = _run(helpers.child_cooperative)
    _wait_pid(r)
    r.stop(grace=5.0)
    assert not r._proc.is_alive()


def test_manager_kill_all():
    r, _ = _run(helpers.child_hang)
    _wait_pid(r)
    ProcessManager.instance().kill_all()
    r._proc.join(timeout=8)
    assert not r._proc.is_alive()


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    """A 1.6 s lossless clip, 1280 x 240, one en cue in the band."""
    cv2 = pytest.importorskip("cv2")
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    bands, _ = load_fixture()
    frames = compose_frames(bands, {
        "width": 1280, "height": 240, "fps": 25, "n_frames": 40,
        "background": [30, 40, 60], "band_origin": [120, 0],
        "cues": [{"band": "band0", "first": 5, "last": 36}]})
    path = str(tmp_path_factory.mktemp("iso") / "tiny.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 240))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    return path


def test_service_process_isolation_e2e(clip_file, tmp_path, monkeypatch):
    """A full extraction in a spawned child through ``ExtractionService``
    on the CPU: COMPLETED, progress and the extractor's messages pumped
    back, and the SRT equal to the in-thread run's. The child, a fresh
    interpreter, takes two intra-op threads from its environment, as the
    test process does (``two_threads``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.core.subtitle_area import SubtitleArea
    from vse_tpu_torch.pipeline.service import Callbacks, ExtractionService, TaskStatus

    cfg = VseConfig(language="en")
    area = SubtitleArea(120, 224, 0, 1280)
    logs, progress = [], []
    results = []
    for isolation in ("process", "thread"):
        svc = ExtractionService(config=cfg, isolation=isolation, device="cpu",
                                callbacks=Callbacks(on_log=lambda t, m: logs.append(m),
                                                    on_progress=lambda t, a, b: progress.append(a)))
        task = svc.add_task(clip_file, area, str(tmp_path / f"{isolation}.srt"))
        svc.run_all(block=True)
        assert task.status == TaskStatus.COMPLETED, task.error
        with open(task.srt_path, encoding="utf-8") as f:
            results.append(f.read())
    assert results[0] == results[1] and "hello" in results[0]
    assert any(str(tmp_path / "process.srt") in m for m in logs) and progress


def test_child_without_cuda_fails_and_does_not_fall_back(clip_file, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.pipeline.service import ExtractionService, TaskStatus

    svc = ExtractionService(config=VseConfig(language="en"), isolation="process")
    task = svc.add_task(clip_file, output_path=str(tmp_path / "o.srt"))
    svc.run_all(block=True)
    assert task.status == TaskStatus.FAILED
    assert "CUDA is not available" in task.error
    assert not os.path.exists(tmp_path / "o.srt")

"""The port's ``ExtractionService`` (thread isolation), mirroring
``tests/test_service.py``: a queue with progress, log, finish and error
callbacks, a failing task, ``stop`` mid-video, ``invalidate_engine``; and
with the real en engine, each task's SRT equal to what
``SubtitleExtractor.run()`` writes for that video, one engine serving the
queue."""

import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.pipeline.service import (
    Callbacks, ExtractionService, ExtractionTask, TaskStatus,
)
from vse_tpu_torch.post.srt import SrtFile
from vse_tpu_torch.video.decode import InMemoryVideo
from vse_tpu_torch.video.synth import compose_frames, load_fixture

W, H, FPS = 320, 240, 25.0
TEXTS = ["hello world", None, "second line"]


def write_video(path, texts, seconds_each=2):
    """White stripes in the bottom band, one stripe phase per segment (the
    JAX package's test video)."""
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for seg, text in enumerate(texts):
        for _ in range(int(seconds_each * FPS)):
            frame = np.full((H, W, 3), 40, np.uint8)
            if text is not None:
                frame[200:224, 20 + seg * 3 : 300 : 5] = 255
            vw.write(frame)
    vw.release()


class FakeEngine:
    """Scripted OCR: the text of a frame's stripe phase."""

    family = "en"

    def __init__(self, texts):
        self.texts = texts

    def predict_batch(self, frames, origin=(0, 0)):
        dy, dx = origin
        out = []
        for f in np.asarray(frames):
            rows = np.nonzero((f > 128).any(axis=(1, 2)))[0]
            if len(rows) == 0:
                out.append(([], []))
                continue
            y0, y1 = int(rows.min()), int(rows.max()) + 1
            seg = max(0, (int(np.nonzero(f[y0, :, 0] > 128)[0][0]) - 20) // 3)
            quad = [(20 + dx, y0 + dy), (300 + dx, y0 + dy), (300 + dx, y1 + dy),
                    (20 + dx, y1 + dy)]
            out.append(([quad], [(self.texts[min(seg, len(self.texts) - 1)], 0.95)]))
        return out


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("svc") / "v.mp4")
    write_video(p, TEXTS)
    return p


def test_service_processes_queue(video, tmp_path):
    events = {"progress": 0, "logs": [], "finished": [], "errors": []}
    svc = ExtractionService(
        config=VseConfig(language="en", word_segmentation=False),
        callbacks=Callbacks(
            on_progress=lambda t, fe, ocr: events.__setitem__("progress", events["progress"] + 1),
            on_log=lambda t, msg: events["logs"].append(msg),
            on_finish=lambda t: events["finished"].append(t),
            on_error=lambda t, e: events["errors"].append(e),
        ),
        device="cpu",
    )
    svc._engine = FakeEngine(TEXTS)
    t1 = svc.add_task(video, output_path=str(tmp_path / "a.srt"))
    t2 = svc.add_task(video, output_path=str(tmp_path / "b.srt"))
    svc.run_all(block=True)
    assert t1.status == t2.status == TaskStatus.COMPLETED
    assert len(events["finished"]) == 2 and not events["errors"]
    assert events["progress"] > 0
    assert len(SrtFile.open(str(tmp_path / "a.srt"))) == 2
    assert t1.progress == 100.0
    # the extractor's messages reach on_log (two a task: done, location)
    assert len(events["logs"]) == 4 and str(tmp_path / "a.srt") in events["logs"][1]


def test_service_marks_failed(tmp_path):
    svc = ExtractionService(config=VseConfig(word_segmentation=False), device="cpu")
    t = svc.add_task(str(tmp_path / "missing.mp4"))
    svc.run_all(block=True)
    assert t.status == TaskStatus.FAILED
    assert t.error


def test_service_needs_cuda_unless_told_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExtractionService(config=VseConfig())
    with pytest.raises(ValueError):
        ExtractionService(config=VseConfig(), isolation="fork", device="cpu")


def test_stop_cancels_mid_video(tmp_path):
    """``stop()`` interrupts the current video between batches: the task
    surfaces FAILED with the cancellation, and the worker exits."""
    path = str(tmp_path / "long.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 48))
    for _ in range(400):
        vw.write(np.zeros((48, 64, 3), np.uint8))
    vw.release()

    class SlowEngine:
        family = "en"

        def predict_batch(self, frames, origin=(0, 0)):
            time.sleep(0.2)
            return [([], []) for _ in range(len(frames))]

    svc = ExtractionService(config=VseConfig(language="en", word_segmentation=False),
                            device="cpu")
    svc._engine = SlowEngine()
    t = svc.add_task(path, output_path=str(tmp_path / "o.srt"))
    svc.run_all(block=False)
    for _ in range(100):
        if t.status == TaskStatus.PROCESSING and t.progress > 0:
            break
        time.sleep(0.05)
    svc.stop()
    svc._worker.join(timeout=30)
    assert not svc._worker.is_alive()
    assert t.status == TaskStatus.FAILED
    assert "Cancelled" in (t.error or "")


def test_remove_task_and_invalidate_engine(video):
    svc = ExtractionService(config=VseConfig(language="en"), device="cpu")
    t = svc.add_task(video)
    assert isinstance(t, ExtractionTask) and svc.remove_task(t) and not svc.tasks
    svc._engine = FakeEngine(TEXTS)
    svc.invalidate_engine()
    assert svc._engine is None


def tiny_clip(name, cue, tmp_path):
    """A 1.6 s in-memory clip, 1280 x 240, one en cue in the band."""
    bands, _ = load_fixture()
    recipe = {"width": 1280, "height": 240, "fps": 25, "n_frames": 40,
              "background": [30, 40, 60], "band_origin": [120, 0],
              "cues": [{"band": cue, "first": 5, "last": 36}]}
    return InMemoryVideo(compose_frames(bands, recipe), 25.0, str(tmp_path / f"{name}.avi"))


def test_queue_srts_equal_single_runs(tmp_path):
    """Two tasks through one service engine (the keyframe strategy, the en
    head): each SRT equals its own ``SubtitleExtractor.run()``'s, and the
    engine the service built serves the second task too; after a config
    change, ``invalidate_engine`` makes the next task build a new one."""
    cfg = VseConfig(language="en")
    area = SubtitleArea(120, 224, 0, 1280)
    clips = [tiny_clip("a", "band0", tmp_path), tiny_clip("b", "band2", tmp_path)]
    built = []
    svc = ExtractionService(config=cfg, device="cpu",
                            callbacks=Callbacks(on_finish=lambda t: built.append(svc._engine)))
    tasks = [svc.add_task(c, area, str(tmp_path / f"svc_{i}.srt")) for i, c in enumerate(clips)]
    svc.run_all(block=True)
    assert all(t.status == TaskStatus.COMPLETED for t in tasks), [t.error for t in tasks]
    assert built[0] is built[1] is not None
    engine = built[0]
    for i, (t, c) in enumerate(zip(tasks, clips)):
        ex = SubtitleExtractor(c, area, cfg, engine=engine, device="cpu")
        ex.subtitle_output_path = str(tmp_path / f"one_{i}.srt")
        ex.append_output = lambda *a: None
        with open(ex.run(), encoding="utf-8") as f, open(t.srt_path, encoding="utf-8") as g:
            want = f.read()
            assert g.read() == want and want.count("-->") == 1
    svc.config = cfg.replace(language="fr")
    svc.invalidate_engine()
    t = svc.add_task(clips[0], area, str(tmp_path / "fr.srt"))
    svc.run_all(block=True)
    assert t.status == TaskStatus.COMPLETED and svc._engine.family == "latin"


def test_service_queue_matches_jax_service(video, tmp_path):
    """The same queue (a good task, a missing file, a good task) through
    the JAX package's service and the port's, with the same scripted OCR:
    the same statuses, SRTs, and log messages (the seconds masked)."""
    import re

    from test_extractor_e2e import FakeEngine as JaxFakeEngine
    from vse_tpu.core.config import VseConfig as JaxConfig
    from vse_tpu.pipeline.service import ExtractionService as JaxService

    runs = []
    for side in ("port", "jax"):
        logs = []
        if side == "port":
            svc = ExtractionService(config=VseConfig(language="en", word_segmentation=False),
                                    callbacks=Callbacks(on_log=lambda t, m: logs.append(m)),
                                    device="cpu")
            svc._engine = FakeEngine(TEXTS)
        else:
            from vse_tpu.pipeline.service import Callbacks as JaxCallbacks

            svc = JaxService(config=JaxConfig(language="en", word_segmentation=False),
                             callbacks=JaxCallbacks(on_log=lambda t, m: logs.append(m)))
            svc._engine = JaxFakeEngine(TEXTS)
        d = tmp_path / side
        d.mkdir()
        tasks = [svc.add_task(video, output_path=str(d / "a.srt")),
                 svc.add_task(str(tmp_path / "missing.mp4")),
                 svc.add_task(video, output_path=str(d / "b.srt"))]
        svc.run_all(block=True)
        srts = [(d / n).read_text(encoding="utf-8") for n in ("a.srt", "b.srt")]
        logs = [re.sub(r"\d+\.\d", "S", m).replace(str(d), "DIR") for m in logs]
        runs.append(([t.status.value for t in tasks], srts, logs))
    assert runs[0] == runs[1]
    assert runs[0][0] == ["completed", "failed", "completed"]

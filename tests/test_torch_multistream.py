"""``extract_many`` and ``interleave_streams`` of the port against the JAX
package's (``vse_tpu/pipeline/multistream.py``), on the CPU, with the real
en engine on tiny clips composed from the smoke fixture's bands and written
losslessly: each video's SRT byte-equal, and every OCR line that the gate
kept equal within the gates of ``tests/_torch_helpers.py`` (frame and text
exact, a box within 2 px, a score within ``SCORE_ATOL`` where the box is
equal)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from _torch_helpers import SCORE_ATOL, two_threads  # noqa: F401
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
from vse_tpu.pipeline import extractor as jax_extractor
from vse_tpu.pipeline import multistream as jax_multistream
from vse_tpu.video.decode import FrameStream as JaxStream
from vse_tpu_torch.core.config import Mode, VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.pipeline import extractor
from vse_tpu_torch.pipeline import multistream
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.video.decode import FrameStream, InMemoryVideo
from vse_tpu_torch.video.synth import compose_frames, load_fixture

# tiny clips: the en bands on a 1280 x 240 frame, 25 fps, each cue one to
# two seconds; clip c is another geometry (1280 x 200)
CLIPS = {
    "a": (240, 80, [("band0", 5, 35), ("band1", 45, 78)]),
    "b": (240, 60, [("band2", 8, 55)]),
    "c": (200, 50, [("band1", 5, 45)]),
}
AREA = (120, 224, 0, 1280)


def clip_frames(name):
    bands, _ = load_fixture()
    height, n, cues = CLIPS[name]
    recipe = {"width": 1280, "height": height, "fps": 25, "n_frames": n,
              "background": [30, 40, 60], "band_origin": [120 if height == 240 else 90, 0],
              "cues": [{"band": b, "first": a, "last": z} for b, a, z in cues]}
    return compose_frames(bands, recipe)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("many")
    paths = {}
    for name in CLIPS:
        frames = clip_frames(name)
        paths[name] = str(d / f"{name}.avi")
        vw = cv2.VideoWriter(paths[name], cv2.VideoWriter_fourcc(*"FFV1"), 25.0,
                             (frames.shape[2], frames.shape[1]))
        for f in frames:
            vw.write(np.ascontiguousarray(f[:, :, ::-1]))
        vw.release()
    return paths


def _keep_gated(cls, seen):
    """Wrap ``cls._gate_lines`` to keep every kept line, per video, in call
    order: [box, text, score]."""
    gate = cls._gate_lines

    def keep(self, dt_box, rec_res):
        kept = gate(self, dt_box, rec_res)
        seen.setdefault(self.video_path, []).extend([list(b), t, p] for b, t, p in kept)
        return kept
    return gate, keep


def run_both(monkeypatch, tmp_path, clips, names, areas):
    """(port, JAX) results of ``extract_many`` on the named clips: {name:
    (SRT text, kept lines)}."""
    out = []
    for side in ("port", "jax"):
        seen = {}
        cls = extractor.SubtitleExtractor if side == "port" else jax_extractor.SubtitleExtractor
        _, keep = _keep_gated(cls, seen)
        monkeypatch.setattr(cls, "_gate_lines", keep)
        srts = [str(tmp_path / f"{side}_{n}.srt") for n in names]
        if side == "port":
            res = multistream.extract_many(
                [clips[n] for n in names],
                [SubtitleArea(*a) if a else None for a in areas],
                VseConfig(language="en"), output_paths=srts, device="cpu")
        else:
            res = jax_multistream.extract_many(
                [clips[n] for n in names], [JaxArea(*a) if a else None for a in areas],
                JaxConfig(language="en"), output_paths=srts)
        assert list(res.values()) == srts
        got = {}
        for n, s in zip(names, srts):
            with open(s, encoding="utf-8") as f:
                got[n] = (f.read(), seen.get(clips[n], []))
        out.append(got)
        monkeypatch.undo()
    return out


def line_mismatches(got, want):
    bad = [(g, w) for g, w in zip(got, want)
           if g[1] != w[1] or max(abs(a - b) for a, b in zip(g[0], w[0])) > 2
           or (g[0] == w[0] and abs(g[2] - w[2]) > SCORE_ATOL)]
    if len(got) != len(want):
        bad.append((len(got), len(want)))
    return bad


@pytest.mark.parametrize("strategy", ["keyframe", "fps"])
def test_extract_many_matches_jax(clips, monkeypatch, tmp_path, strategy):
    """Clips a and b: with one area (keyframe), their samples share OCR
    chunks; with none (fps), their sampled frames share batches."""
    names = ["a", "b"]
    areas = [AREA, AREA] if strategy == "keyframe" else [None, None]
    port, jax = run_both(monkeypatch, tmp_path, clips, names, areas)
    for n in names:
        assert port[n][0] == jax[n][0], (n, port[n][0], jax[n][0])
        assert port[n][1], n  # the gate kept lines
        assert not line_mismatches(port[n][1], jax[n][1]), n
    texts = "".join(port[n][0] for n in names)
    assert "hello" in texts and "second" in texts


def test_pooled_reads_equal_single_video_reads(clips, tmp_path):
    """A sample's read does not depend on its chunk-mates: each video's
    SRT from the pooled keyframe run equals its own ``SubtitleExtractor``
    run's. Clip c's band has another shape, so its samples get chunks of
    their own: the chunks are ceil(samples / frame_batch) per shape."""
    cfg = VseConfig(language="en")
    stats = {}
    names = ("a", "b", "c")
    areas = [SubtitleArea(*AREA), SubtitleArea(*AREA), SubtitleArea(90, 194, 0, 1280)]
    srts = [str(tmp_path / f"many_{n}.srt") for n in names]
    multistream.extract_many([clips[n] for n in names], areas, cfg,
                             output_paths=srts, device="cpu", stats=stats)
    ab, c = sum(stats["samples"][:2]), stats["samples"][2]
    assert stats["chunks"] == -(-ab // cfg.frame_batch) + -(-c // cfg.frame_batch)
    assert stats["samples"][0] % cfg.frame_batch, "no chunk holds samples of a and b"
    engine = None
    for n, area, pooled in zip(names, areas, srts):
        ex = SubtitleExtractor(clips[n], area, cfg, engine=engine, device="cpu")
        ex.subtitle_output_path = str(tmp_path / f"one_{n}.srt")
        ex.append_output = lambda *a: None
        with open(ex.run(), encoding="utf-8") as f, open(pooled, encoding="utf-8") as g:
            assert f.read() == g.read(), n
        engine = ex.engine


def test_interleave_covers_every_frame_once_and_routes_it_back(clips):
    """Three in-memory clips of different lengths whose every frame encodes
    (video, frame number): each sampled frame lands in exactly one batch
    row, tagged with its own video and frame number; the padding rows are
    black and untagged; the tags equal the JAX package's on the same
    files."""
    lengths = (23, 9, 40)
    videos = []
    for v, n in enumerate(lengths):
        f = np.zeros((n, 4, 6, 3), np.uint8)
        f[:, :, :, 0] = v + 1
        f[:, :, :, 1] = np.arange(1, n + 1)[:, None, None]
        videos.append(InMemoryVideo(f, 25.0, f"v{v}.avi"))
    for stride in (1, 8):
        streams = [FrameStream(v, batch_size=4, stride=stride) for v in videos]
        seen = []
        for batch in multistream.interleave_streams(streams, 8):
            for i in range(8):
                if not batch.valid[i]:
                    assert batch.video_ids[i] == -1 and not batch.frames[i].any()
                    continue
                v, no = int(batch.video_ids[i]), int(batch.frame_nos[i])
                assert batch.frames[i, 0, 0, 0] == v + 1 and batch.frames[i, 0, 0, 1] == no
                seen.append((v, no))
        want = [(v, k) for v, n in enumerate(lengths) for k in range(1, n + 1, stride)]
        assert sorted(seen) == want
    # on the lossless files: every sampled frame once, as the JAX
    # package's interleave covers them (its batches, and so its tags'
    # order, depend on decode timing: ROADMAP fault 5)
    names = ["a", "b"]
    tags = []
    for mod, stream in ((multistream, FrameStream), (jax_multistream, JaxStream)):
        tags.append(sorted(
            (int(b.video_ids[i]), int(b.frame_nos[i]))
            for b in mod.interleave_streams([stream(clips[n], batch_size=8, stride=8)
                                             for n in names], 8)
            for i in range(8) if b.valid[i]))
    assert tags[0] == tags[1] == [(v, k) for v, n in enumerate(names)
                                  for k in range(1, CLIPS[n][1] + 1, 8)]


def test_extract_many_fps_routes_results():
    """``extract_many_fps`` with an engine that reads each frame's tag:
    every video's samples come back to it, sorted by frame, and
    ``on_result`` sees each once."""
    import torch

    class TagEngine:
        device = torch.device("cpu")

        def predict_batch(self, frames, origin=(0, 0)):
            f = np.asarray(frames)
            return [([], [(f"v{int(x[0, 0, 0])}f{int(x[0, 0, 1])}", 1.0)]) for x in f]

    videos = []
    for v, n in enumerate((30, 17)):
        f = np.zeros((n, 4, 6, 3), np.uint8)
        f[:, :, :, 0] = v
        f[:, :, :, 1] = np.arange(1, n + 1)[:, None, None]
        videos.append(InMemoryVideo(f, 24.0, f"v{v}.avi"))
    seen = []
    out = multistream.extract_many_fps(videos, TagEngine(), VseConfig(language="en"),
                                       on_result=lambda v, no, b, r: seen.append((v, no)))
    assert sorted(seen) == sorted((v, r[0]) for v, p in enumerate(out) for r in out[p])
    for v, (p, n) in enumerate(zip(("v0.avi", "v1.avi"), (30, 17))):
        nos = [r[0] for r in out[p]]
        assert nos == list(range(1, n + 1, 8))  # 24 fps // 3 a second
        assert [r[2][0][0] for r in out[p]] == [f"v{v}f{k}" for k in nos]


@pytest.mark.parametrize("mode", ["auto", "accurate"])
def test_extract_many_raises_for_modes_not_ported(clips, mode):
    with pytest.raises(NotImplementedError, match="det_server"):
        multistream.extract_many([clips["a"]], [SubtitleArea(*AREA)],
                                 VseConfig(language="en", mode=Mode(mode)), device="cpu")

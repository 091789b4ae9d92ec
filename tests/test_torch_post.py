"""The port's host post-processing against the JAX package's, on the CPU:
word segmentation and reformat, SRT parsing and the transcript, the fps
strategy's cue maker, the watermark and scene-text filters, and the resume
manifest's on-disk format. All comparisons are exact (strings, integers,
bytes)."""

import json
import os
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from vse_tpu.pipeline import resume as jax_resume
from vse_tpu.post import dedup as jax_dedup
from vse_tpu.post import filters as jax_filters
from vse_tpu.post import reformat as jax_reformat
from vse_tpu.post import srt as jax_srt
from vse_tpu.post import wordseg as jax_wordseg
from vse_tpu.post.records import RawRecord as JaxRecord
from vse_tpu_torch.pipeline import resume
from vse_tpu_torch.post import dedup, filters, reformat, srt, wordseg
from vse_tpu_torch.post.records import RawRecord

WORDS = wordseg._COMMON[:400] + ["subtitle", "okay", "gonna", "jumps", "walked"]
CONTRACTIONS = ["I'm", "don't", "can't", "it's", "we're", "they'll", "won't"]


@pytest.fixture(scope="module")
def segmenters():
    return wordseg.Segmenter(), jax_wordseg.Segmenter()


def test_corpus_and_scores_are_the_jax_packages(segmenters):
    port, ref = segmenters
    assert wordseg._COMMON == jax_wordseg._COMMON
    assert port.unigrams == ref.unigrams and port.total == ref.total
    for w in WORDS[:50] + ["zzqx", "hellofrom"]:
        assert port.score(w) == ref.score(w)


def joined_runs(seed: int, n: int = 60):
    """Sentences of corpus words and contractions, glued into runs the way
    an OCR head without a space class reads them, with punctuation."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        words = [rng.choice(WORDS + CONTRACTIONS) for _ in range(rng.randint(1, 8))]
        glued = "".join(words) if rng.random() < 0.7 else " ".join(words)
        if rng.random() < 0.5:
            glued = glued[0].upper() + glued[1:]
        out.append(glued + rng.choice(["", ".", "?", "!", ",", " ."]))
    return out


MIXED = [
    "你好world", "今天我们gotothepark", "他说 ok 好的", "hello，world。",
    "Dr. smithsaid“hi”", "50 % off", "word -suffix", "l'm here", "Let'sqo now",
    "Iife is good", "威筋", "line one\n  line two", "", "A", "·end·",
    "hellofromthenewportonthecard", "asecondlineoftextcomeshere",
]


@pytest.mark.parametrize("lang", ["en", "ch"])
def test_reformat_text_matches_on_words_runs_and_mixes(segmenters, lang):
    port, ref = segmenters
    typo = reformat.load_typo_map()
    assert typo == jax_reformat.load_typo_map()
    for text in WORDS + CONTRACTIONS + joined_runs(1) + MIXED:
        assert reformat.reformat_text(text, lang, typo, port) == \
            jax_reformat.reformat_text(text, lang, typo, ref), text


@settings(max_examples=150, deadline=None)
@given(st.lists(st.sampled_from(WORDS[:120] + CONTRACTIONS + ["你好", "世界", " ", ",", ".", "?",
                                                              "'", "\n", "%", "-", "，", "。"]),
                max_size=10))
def test_reformat_text_matches_on_random_mixes(parts):
    text = "".join(parts)
    port, ref = wordseg.Segmenter(), jax_wordseg.Segmenter()
    assert reformat.reformat_text(text, "en", None, port) == \
        jax_reformat.reformat_text(text, "en", None, ref)


def write_srt(path, texts):
    with open(path, "w", encoding="utf-8") as f:
        for i, t in enumerate(texts):
            f.write(f"{i + 1}\n00:00:{i:02d},000 --> 00:00:{i:02d},900\n{t}\n\n")


def test_execute_rewrites_the_file_as_the_jax_package(tmp_path):
    texts = joined_runs(2, 25) + MIXED[:-3] + ["x" * 1001]
    a, b = str(tmp_path / "port.srt"), str(tmp_path / "jax.srt")
    write_srt(a, texts)
    write_srt(b, texts)
    assert reformat.execute(a, "en") and jax_reformat.execute(b, "en")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert not reformat.execute(str(tmp_path / "missing.srt"))


def test_execute_keeps_a_bad_cues_text(tmp_path, monkeypatch):
    """The per-cue try: a cue whose reformat raises keeps its text."""
    path = str(tmp_path / "a.srt")
    write_srt(path, ["hellothere", "boom", "goodmorning"])

    real = reformat.reformat_text

    def flaky(text, *a, **k):
        if text == "boom":
            raise RuntimeError("bad cue")
        return real(text, *a, **k)

    monkeypatch.setattr(reformat, "reformat_text", flaky)
    assert reformat.execute(path, "en")
    assert [i.text for i in srt.SrtFile.open(path)] == ["hello there", "boom", "good morning"]


SRT_TEXTS = [
    "1\n00:00:01,000 --> 00:00:02,500\nhello\n\n2\n00:00:03,000 --> 00:00:04,000\ntwo\nlines\n",
    "﻿1\r\n00:00:01.000 --> 00:00:02.000\r\nbom and crlf\r\n\r\n",
    "00:01:00,001 --> 01:00:00,000\nno index\n\n\n7\n00:00:05,000 --> 00:00:06,000\n\n"
    "junk block without a time line\n\n8\n00:00:07,000 --> 00:00:08,000\nafter junk",
    "",
]


@pytest.mark.parametrize("data", SRT_TEXTS)
def test_srt_loads_dumps_and_txt_match(data, tmp_path):
    got, want = srt.SrtFile.loads(data), jax_srt.SrtFile.loads(data)
    assert [(i.index, i.start_ms, i.end_ms, i.text) for i in got] == \
        [(i.index, i.start_ms, i.end_ms, i.text) for i in want]
    assert got.dumps() == want.dumps()
    got.reindex()
    want.reindex()
    assert got.dumps() == want.dumps()
    a, b = tmp_path / "a.srt", tmp_path / "b.srt"
    a.write_text(data, encoding="utf-8")
    b.write_text(data, encoding="utf-8")
    assert srt.SrtFile.open(str(a)).dumps() == jax_srt.SrtFile.open(str(b)).dumps()
    assert open(srt.srt_to_txt(str(a)), "rb").read() == open(jax_srt.srt_to_txt(str(b)), "rb").read()
    out = srt.srt_to_txt(str(a), str(tmp_path / "x.txt"))
    assert out.endswith("x.txt")


@pytest.mark.parametrize("ts", ["00:00:01,000", "1:2:3.4", "junk 10:00:00,999 junk"])
def test_timestamp_to_ms(ts):
    assert srt.timestamp_to_ms(ts) == jax_srt.timestamp_to_ms(ts)
    with pytest.raises(ValueError):
        srt.timestamp_to_ms("no time")


def random_records(seed: int, n: int = 120):
    """Records on a few rows: a constant watermark, subtitles whose text
    changes, jittered coordinates, and some scene text off the rows."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        frame = int(8 * k + 1)
        if rng.random() < 0.9:
            j = rng.integers(-6, 7, 4)
            out.append((frame, (1080 + j[0], 1230 + j[1], 24 + j[2], 70 + j[3]), "VSE TV"))
        if rng.random() < 0.8:
            j = rng.integers(-40, 41, 4)
            text = ["hello there", "second line", "the last one"][(k // 15) % 3]
            out.append((frame, (300 + j[0], 980 + j[1], 630 + j[2] // 8, 670 + j[3] // 8), text))
        if rng.random() < 0.1:
            j = rng.integers(0, 400, 2)
            out.append((frame, (j[0], j[0] + 200, 300 + j[1] // 4, 340 + j[1] // 4), "CITY CAFE"))
    return ([RawRecord(f, tuple(int(v) for v in c), t) for f, c, t in out],
            [JaxRecord(f, tuple(int(v) for v in c), t) for f, c, t in out])


def as_tuples(records):
    return [(r.frame_no, tuple(r.coord), r.text) for r in records]


@pytest.mark.parametrize("seed", range(6))
def test_filters_match_with_the_auto_policy_and_a_confirm(seed):
    port, ref = random_records(seed)
    coords = [r.coord for r in port]
    assert filters.unite_coordinates(coords) == jax_filters.unite_coordinates(coords)
    assert filters.unite_coordinates(coords, 30, 10) == jax_filters.unite_coordinates(coords, 30, 10)
    assert filters.detect_watermark_areas(port, 3) == jax_filters.detect_watermark_areas(ref, 3)
    assert filters.detect_subtitle_band(port) == jax_filters.detect_subtitle_band(ref)
    for coord, n in filters.detect_watermark_areas(port):
        match = [r for r in port if r.coord == coord]
        assert filters.auto_watermark_policy(coord, match) == \
            jax_filters.auto_watermark_policy(coord, [r for r in ref if r.coord == coord])
    assert as_tuples(filters.filter_watermark(port)) == as_tuples(jax_filters.filter_watermark(ref))
    for answers in ([True, False, True, False, True], [False] * 5):
        asked = {"port": [], "jax": []}

        def confirm(side):
            it = iter(answers)
            return lambda prompt: asked[side].append(prompt) or next(it)

        got = filters.filter_watermark(port, confirm=confirm("port"))
        want = jax_filters.filter_watermark(ref, confirm=confirm("jax"))
        assert as_tuples(got) == as_tuples(want) and asked["port"] == asked["jax"]
        for yes in (True, False):
            asked = {"port": [], "jax": []}
            got = filters.filter_scene_text(port, 50, lambda p: asked["port"].append(p) or yes)
            want = jax_filters.filter_scene_text(ref, 50, lambda p: asked["jax"].append(p) or yes)
            assert as_tuples(got) == as_tuples(want) and asked["port"] == asked["jax"]
    assert as_tuples(filters.filter_scene_text(port)) == as_tuples(jax_filters.filter_scene_text(ref))
    assert filters.filter_scene_text([]) == [] and filters.detect_subtitle_band([]) == (0, 0)


@pytest.mark.parametrize("seed", range(3))
def test_generate_srt_matches(seed):
    rng = np.random.default_rng(seed)
    spans = []
    f = 1
    for _ in range(12):
        f += int(rng.integers(1, 60))
        end = f + int(rng.integers(0, 80))
        spans.append((f, end, f"cue {f}\n" if rng.random() < 0.3 else f"cue {f}"))
        f = end
    ms = {int(k): float(k * 40.0 + rng.random()) for k in range(1, f + 40, 2)}

    def frame_to_ms(k):
        return ms.get(k, k / 25.0 * 1000.0)

    got, got_pad = dedup.generate_srt(spans, frame_to_ms, 25.0)
    want, want_pad = jax_dedup.generate_srt(spans, frame_to_ms, 25.0)
    assert got.dumps() == want.dumps() and got_pad == want_pad
    recs = [RawRecord(s, (0, 1, 2, 3), t) for s, _, t in spans]
    jrecs = [JaxRecord(s, (0, 1, 2, 3), t) for s, _, t in spans]
    assert dedup.remove_duplicate_subtitles(recs, single_frame_extends=True) == \
        jax_dedup.remove_duplicate_subtitles(jrecs, single_frame_extends=True)


def test_manifest_written_by_either_package_loads_in_the_other(tmp_path):
    video = str(tmp_path / "clip.avi")
    recs = [(17, (1, 2, 3, 4), "héllo"), (25, (5, 6, 7, 8), "wörld")]
    port = resume.ProgressManifest(video, "fps", 25, [RawRecord(*r) for r in recs])
    path = port.save()
    assert path == jax_resume.ProgressManifest.path_for(video) == resume.ProgressManifest.path_for(video)
    loaded = jax_resume.ProgressManifest.load(video, "fps")
    assert loaded.last_frame_no == 25 and as_tuples(loaded.records) == recs
    with open(path, encoding="utf-8") as f:
        port_bytes = f.read()
    jax_resume.ProgressManifest(video, "fps", 25, [JaxRecord(*r) for r in recs]).save()
    with open(path, encoding="utf-8") as f:
        assert f.read() == port_bytes
    back = resume.ProgressManifest.load(video, "fps")
    assert back.last_frame_no == 25 and as_tuples(back.records) == recs
    assert json.loads(port_bytes)["version"] == 1
    assert resume.ProgressManifest.load(video, "keyframe") is None
    assert resume.ProgressManifest.load(str(tmp_path / "other.avi"), "fps") is None
    back.clear()
    assert not os.path.exists(path) and resume.ProgressManifest.load(video, "fps") is None
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []

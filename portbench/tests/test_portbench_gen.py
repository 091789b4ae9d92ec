"""The clip generator: the same seed gives the same pool, no line repeats in
a pool or its warm-up clip, and the frames carry the planned cues."""

import json
import os

import numpy as np

from _helpers import PB


from gen import subtitle_clips as gen


def _traffic(name="keyframe-area"):
    with open(os.path.join(PB, "traffic", name + ".json"), "r", encoding="utf-8") as f:
        return json.load(f)


def test_plan_is_deterministic_per_seed():
    t = _traffic()
    a = gen.plan_pool(t, 2 ** 31 + 5)
    assert a == gen.plan_pool(t, 2 ** 31 + 5)
    assert a != gen.plan_pool(t, 2 ** 31 + 6)


def test_no_line_repeats_in_a_pool():
    for name in sorted(f[:-5] for f in os.listdir(os.path.join(PB, "traffic"))):
        t = _traffic(name)
        clips = gen.plan_pool(t, 123456789012)
        texts = [c["text"] for clip in clips for c in clip["cues"]]
        assert len(texts) == len(set(texts))
        fps = t["fps"]
        for clip in clips:
            # the same cues in every clip, in an order of its own
            got = sorted(((c["last"] - c["first"] + 1) / fps, len(c["cells"]))
                         for c in clip["cues"])
            want = sorted((d, n) for d, _, n in t["cues"])
            assert [n for _, n in got] == [n for _, n in want]
            assert all(abs(a - b) <= 1.5 / fps for (a, _), (b, _) in zip(got, want))
            for c in clip["cues"]:
                assert 1 <= c["first"] <= c["last"] <= clip["n_frames"]


def test_frames_carry_the_cues():
    t = _traffic()
    t = dict(t, clip_seconds=4, cues=[[1.5, 0.5, 5], [1.0, 0.4, 12]])
    clip = gen.plan_pool(t, 99)[1]
    g = gen._load_glyphs(t["glyphs"])
    frames = gen.render_frames(t, clip, g, {})
    y0, y1 = t["bar_rows"]
    bar = frames[:, y0:y1].astype(int)
    ink = (np.abs(bar - np.asarray(t["bar_color"])).sum(-1) > 30).any(axis=(1, 2))
    want = np.zeros(len(frames), bool)
    for c in clip["cues"]:
        want[c["first"] - 1:c["last"]] = True
    assert (ink == want).all()

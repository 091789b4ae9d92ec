"""The port's sync re-timer (``vse_tpu_torch/sync/``) against the JAX
package's (``vse_tpu/sync/``) on the CPU.

- The plain modules (``common``, ``timecodes``, ``events``) on the cases of
  ``tests/test_sync.py``, and SRT/ASS scripts parsed and saved by both
  packages: the saved files byte-equal.
- ``match``: the numpy matcher is the JAX package's bit for bit; the
  device matcher (``torch.fft``, here on the CPU) finds the same offsets as
  the JAX device matcher (XLA's FFT) on planted offsets, its score within
  ``SCORE_ATOL`` of JAX's (both f32 FFTs, summed in other orders).
- ``wav``: 16-bit, 24-bit and 32-bit float WAVs, mono and stereo, at the
  sample rate and resampled, load to equal ``data`` arrays.
- ``engine``: each event's shift and diff on ``tests/test_sync.py``'s
  audio pair equal to the JAX engine's (floats equal) with the numpy
  matcher; with the device matchers, diffs within ``SCORE_ATOL`` and the
  weighted shifts within 1e-9 s.
- ``runner`` and the CLIs: SRT and ASS scripts, with and without grouping,
  with fps-based keyframe logs, the numpy and the device matcher: output
  scripts byte-equal; ``python -m vse_tpu_torch.cli sync`` writes the JAX
  CLI's file, and both print the same error without ``--src``.
- ``tools/sync_regression_torch.py`` gives the verdicts of
  ``tools/sync_regression.py`` on the same configs.
"""

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from vse_tpu.sync import common as j_common
from vse_tpu.sync import engine as j_engine
from vse_tpu.sync import events as j_events
from vse_tpu.sync import match as j_match
from vse_tpu.sync import timecodes as j_timecodes
from vse_tpu.sync import wav as j_wav
from vse_tpu.sync.cli import create_arg_parser as j_parser
from vse_tpu.sync.runner import run as j_run
from vse_tpu_torch.sync import common, engine, events, match, timecodes, wav
from vse_tpu_torch.sync.cli import create_arg_parser
from vse_tpu_torch.sync.runner import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 12000
# the device matchers' best scores: f32 FFTs and cumsums in two orders
SCORE_ATOL = 1e-3


def write_wav(path, data_f32, rate=RATE):
    pcm = np.clip(data_f32 * 32767, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def audio_pair(tmp_path_factory):
    """``tests/test_sync.py``'s pair: 30 s of structured noise, and the same
    delayed by 1.7 s."""
    rng = np.random.default_rng(42)
    src = rng.normal(0, 0.3, size=30 * RATE).astype(np.float32)
    src *= np.abs(np.sin(np.linspace(0, 40, len(src)))) + 0.1
    dst = np.concatenate([np.zeros(int(1.7 * RATE), np.float32), src])
    d = tmp_path_factory.mktemp("wav")
    write_wav(str(d / "src.wav"), src)
    write_wav(str(d / "dst.wav"), dst)
    return str(d / "src.wav"), str(d / "dst.wav")


def make_srt(path, cues):
    blocks = [f"{i + 1}\n{common.format_srt_time(a)} --> {common.format_srt_time(b)}\n{t}"
              for i, (a, b, t) in enumerate(cues)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n\n".join(blocks) + "\n")


ASS_HEAD = """[Script Info]
Title: t
ScriptType: v4.00+

[V4+ Styles]
Format: Name, Fontname, Fontsize
Style: Default,Arial,20

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
"""


def make_ass(path, cues):
    lines = [f"{'Comment' if t.startswith('#') else 'Dialogue'}: 0,"
             f"{common.format_time(a)},{common.format_time(b)},Default,,0,0,0,,{t}"
             for a, b, t in cues]
    with open(path, "w", encoding="utf-8") as f:
        f.write(ASS_HEAD + "\n".join(lines) + "\n")


CUES = [(2.0 + 3 * i, 4.0 + 3 * i, f"line {i}, with, commas") for i in range(8)]
# short typesetting lines, a duplicate, a zero-length line and a comment
ASS_CUES = CUES[:3] + [(11.0, 11.2, "ts a"), (11.25, 11.4, "ts b"), (11.0, 11.2, "ts a"),
                       (12.0, 12.0, "zero"), (13.0, 14.0, "# note")] + CUES[4:]


# --- common, timecodes, events --------------------------------------------

@pytest.mark.parametrize("seconds", [0.0, 1.005, 59.999, 61.234, 3599.995, 7322.5, 36000.01])
def test_time_formatting(seconds):
    assert common.format_time(seconds) == j_common.format_time(seconds)
    assert common.format_srt_time(seconds) == j_common.format_srt_time(seconds)
    assert common.clip(seconds, 1.0, 60.0) == j_common.clip(seconds, 1.0, 60.0)
    assert common.get_extension("A/b.SRT") == j_common.get_extension("A/b.SRT") == ".srt"


def test_interpolate_median_smooth_groups():
    assert engine.interpolate_nones([1.0, None, 3.0], [0, 1, 2]) == [1.0, 2.0, 3.0]
    assert engine.interpolate_nones([None, None], [0, 1]) == []
    vals = [1.0, 1.0, 9.0, 1.0, 1.0, 4.0, 2.0]
    for w in (1, 3, 5):
        assert engine.running_median(vals, w) == j_engine.running_median(vals, w)
    with pytest.raises(common.SyncError):
        engine.running_median(vals, 2)
    evs = [events.Event(i, float(i), i + 1.0, "x") for i in range(5)]
    for e, v in zip(evs, vals):
        e.set_shift(v, 0.1)
    engine.smooth_events(evs, radius=1)
    assert [e.shift for e in evs] == [1.0] * 5
    jumps = []
    for i, s in enumerate([0.0, 0.001, 0.002, 1.0, 1.001]):
        e = events.Event(i, float(i), i + 0.5, "x")
        e.set_shift(s, 0.1)
        jumps.append(e)
    assert [len(g) for g in engine.detect_groups(jumps)] == [3, 2]


def test_fix_near_borders_and_search_groups():
    evs = []
    for i in range(12):
        e = events.Event(i, float(i), i + 0.5, "x")
        e.set_shift(1.0, 0.5 if i not in (0, 11) else 50.0)
        evs.append(e)
    engine.fix_near_borders(evs)
    assert evs[0].linked and evs[11].linked and not evs[5].linked
    e0, dup = events.Event(0, 1.0, 2.0, "a"), events.Event(1, 1.0, 2.0, "a-dup")
    zero, comment = events.Event(2, 3.0, 3.0, "zero"), events.Event(3, 4.0, 5.0, "c")
    comment.is_comment = True
    tail = events.Event(4, 6.0, 8.0, "tail")
    groups = engine.prepare_search_groups([e0, dup, zero, comment, tail], 100.0, [], 0.4, 0.4)
    assert dup.linked and zero.linked and comment.linked
    assert [g[0] for g in groups] == [e0, tail]
    short = [events.Event(0, 0.0, 0.1, "a"), events.Event(1, 0.15, 0.25, "b"),
             events.Event(2, 0.3, 0.4, "c"), events.Event(3, 5.0, 8.0, "d")]
    assert [len(g) for g in engine.merge_short_lines_into_groups(short, [], 0.5, 0.5)] == [3, 1]


def test_timecodes_and_keyframe_logs(tmp_path):
    for mod in (timecodes, j_timecodes):
        tc = mod.Timecodes.cfr(25.0)
        assert tc.get_frame_time(50) == pytest.approx(2.0)
        assert tc.get_frame_number(2.0) == 50
    texts = ["# timecode format v2\n0\n40\n80\n120\n",
             "# timecode format v1\nAssume 25\n10,19,50\n30,31,12.5\n"]
    for text in texts:
        a, b = timecodes.Timecodes.parse(text), j_timecodes.Timecodes.parse(text)
        assert a.times == b.times and a.default_frame_duration == b.default_frame_duration
        for t in (0.0, 0.09, 0.5, 1.3, 9.0):
            assert a.get_frame_number(t) == b.get_frame_number(t)
            assert a.get_frame_size(t) == b.get_frame_size(t)
        for n in (0, 3, 25, 40, 400):
            assert a.get_frame_time(n) == b.get_frame_time(n)
    with pytest.raises(common.SyncError):
        timecodes.Timecodes.parse("# timecode format v9\n")
    scx = "# XviD 2pass stat file\njunk\njunk\ni\np\ni\n"
    assert timecodes.parse_scxvid_keyframes(scx) == j_timecodes.parse_scxvid_keyframes(scx) == [0, 2]
    plain = tmp_path / "kf.txt"
    plain.write_text("# keyframe format v1\nfps 0\n0\n48\n97\n")
    assert timecodes.parse_keyframes(str(plain)) == j_timecodes.parse_keyframes(str(plain))


def test_chapter_readers(tmp_path):
    ogm = tmp_path / "ch.txt"
    ogm.write_text("CHAPTER01=00:00:00.000\nCHAPTER01NAME=a\nCHAPTER02=00:01:30,500\n"
                   "chapter03 = 00:10:00.250\n")
    xml = tmp_path / "ch.xml"
    xml.write_text("<Chapters><EditionEntry><ChapterAtom><ChapterTimeStart>00:05:00.000000000"
                   "</ChapterTimeStart></ChapterAtom><ChapterAtom><ChapterTimeStart>00:00:01.5"
                   "</ChapterTimeStart></ChapterAtom></EditionEntry></Chapters>")
    assert timecodes.get_ogm_start_times(str(ogm)) == j_timecodes.get_ogm_start_times(str(ogm)) \
        == [0.0, 90.5, 600.25]
    assert timecodes.get_xml_start_times(str(xml)) == j_timecodes.get_xml_start_times(str(xml)) \
        == [1.5, 300.0]


@pytest.mark.parametrize("kind", ["srt", "ass"])
def test_scripts_parse_and_save_byte_equal(tmp_path, kind):
    src = str(tmp_path / f"in.{kind}")
    if kind == "srt":
        make_srt(src, CUES)
        with open(src, "a", encoding="utf-8") as f:  # a CRLF cue with a BOM-less 2-line body
            f.write("\n9\r\n00:00:40.5 --> 00:00:42,25\r\ntwo\r\nlines\r\n")
        loaders = (events.SrtScript, j_events.SrtScript)
    else:
        make_ass(src, ASS_CUES)
        loaders = (events.AssScript, j_events.AssScript)
    outs = []
    for i, loader in enumerate(loaders):
        script = loader.from_file(src)
        script.sort_by_time()
        for k, e in enumerate(script.events):
            if not e.is_comment:
                e.set_shift(0.123 * k, 0.1)
                e.adjust_additional_shifts(0.01, -0.02)
                e.apply_shift()
        out = str(tmp_path / f"out{i}.{kind}")
        script.save_to_file(out)
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and len(outs[0]) > 300
    with pytest.raises(common.SyncError):
        loaders[0].from_file(str(tmp_path / "missing"))


# --- match ------------------------------------------------------------------

@pytest.mark.parametrize("n,start,m,noise", [(4096, 1000, 500, 0.0), (2048, 300, 400, 0.01),
                                             (50000, 31234, 7000, 0.05), (9000, 0, 9000, 0.0),
                                             (30000, 29000, 1000, 0.02)])
def test_matchers(n, start, m, noise):
    rng = np.random.default_rng(n + start)
    image = rng.normal(size=n).astype(np.float32)
    tpl = image[start : start + m] + rng.normal(0, noise, m).astype(np.float32)
    want = j_match.match_template_numpy(image, tpl)
    got = match.match_template_numpy(image, tpl)
    assert got == want and got[1] == start  # the numpy matcher, bit for bit
    j_score, j_off = j_match.match_template_device(image, tpl)
    score, off = match.match_template_device(image, tpl, device="cpu")
    assert off == j_off == start
    assert score == pytest.approx(j_score, abs=SCORE_ATOL)
    assert score == pytest.approx(want[0], abs=SCORE_ATOL)


def test_device_matcher_refuses_a_longer_template():
    with pytest.raises(ValueError):
        match.match_template_device(np.zeros(10), np.zeros(11), device="cpu")


# --- wav ------------------------------------------------------------------

def write_pcm(path, samples, rate, width, float_fmt=False):
    """A RIFF/WAVE file of interleaved samples [n, channels]: PCM of
    ``width`` bytes, or IEEE float (format 3) when ``float_fmt``."""
    n, ch = samples.shape
    if float_fmt:
        data, tag = samples.astype("<f4").tobytes(), 3
    elif width == 3:
        v = np.clip(samples * 8388607, -8388608, 8388607).astype("<i4").view(np.uint8)
        data, tag = v.reshape(-1, 4)[:, :3].tobytes(), 1
    else:
        data, tag = np.clip(samples * 32767, -32768, 32767).astype("<i2").tobytes(), 1
    import struct

    fmt = struct.pack("<HHLLHH", tag, ch, rate, rate * ch * width, ch * width, width * 8)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + 6 + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"LIST" + struct.pack("<I", 6) + b"abcdef")  # a chunk to skip
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("width,float_fmt", [(2, False), (3, False), (4, True)])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate", [12000, 22050])
def test_wav_loads_equal(tmp_path, width, float_fmt, channels, rate):
    rng = np.random.default_rng(width * 10 + channels)
    x = (rng.normal(0, 0.2, (int(2.5 * rate), channels))
         * (np.abs(np.sin(np.linspace(0, 9, int(2.5 * rate))))[:, None] + 0.1))
    path = str(tmp_path / "a.wav")
    write_pcm(path, x.astype(np.float32), rate, width, float_fmt)
    for sample_type in ("uint8", "float32"):
        got = wav.WavStream(path, 12000, sample_type, device="cpu")
        want = j_wav.WavStream(path, 12000, sample_type)
        np.testing.assert_array_equal(got.data, want.data)
        assert got.duration_seconds == want.duration_seconds
        assert got.find_substream(got.data[40000:46000], 2.0, 1.5) == \
            want.find_substream(want.data[40000:46000], 2.0, 1.5)


def test_wav_rejects_what_the_reference_rejects(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX0000WAVE")
    for mod in (wav, j_wav):
        with pytest.raises((common.SyncError, j_common.SyncError)):
            mod.WavStream(str(bad))
    with pytest.raises(common.SyncError):
        wav.WavStream(str(bad), sample_type="int16")


def test_wav_matcher_choice(audio_pair, monkeypatch):
    src, _ = audio_pair
    assert wav.WavStream(src, device="cpu")._match is match.match_template_numpy
    monkeypatch.setenv("VSE_SYNC_DEVICE", "1")
    s = wav.WavStream(src, device="cpu")
    assert s._match.func is match.match_template_device and s._match.keywords["device"].type == "cpu"
    assert wav.WavStream(src, use_device_matcher=False, device="cpu")._match \
        is match.match_template_numpy


# --- engine -----------------------------------------------------------------

@pytest.mark.parametrize("device_matcher", [False, True])
def test_engine_shifts_equal(audio_pair, device_matcher):
    src, dst = audio_pair
    cues = [(1.5 + 2.9 * i, 3.1 + 2.9 * i, "x") for i in range(9)] + [(29.5, 31.0, "late")]
    shifts = []
    for ev_mod, eng, streams in (
            (events, engine, lambda p: wav.WavStream(p, use_device_matcher=device_matcher,
                                                     device="cpu")),
            (j_events, j_engine, lambda p: j_wav.WavStream(p, use_device_matcher=device_matcher))):
        evs = [ev_mod.Event(i, a, b, t) for i, (a, b, t) in enumerate(cues)]
        s, d = streams(src), streams(dst)
        groups = eng.prepare_search_groups(evs, s.duration_seconds, [], 0.417, 0.417)
        eng.calculate_shifts(s, d, groups, 10, 30, 5)
        eng.fix_near_borders(evs)
        eng.smooth_events([e for e in evs if not e.linked], 3)
        for g in eng.detect_groups(evs):
            eng.average_shifts(g)
        shifts.append([(e.shift, e.diff, e.linked) for e in evs])
    if device_matcher:  # scores within SCORE_ATOL, so the weighted shifts within 1e-9
        assert [x[2] for x in shifts[0]] == [x[2] for x in shifts[1]]
        for (s0, d0, _), (s1, d1, _) in zip(*shifts):
            assert abs(s0 - s1) < 1e-9 and abs(d0 - d1) < SCORE_ATOL
    else:  # the numpy matcher: every float equal
        assert shifts[0] == shifts[1]
    assert all(abs(s - 1.7) < 0.01 for s, _, _ in shifts[0][:9])


# --- runner and CLIs --------------------------------------------------------

def keyframe_logs(tmp_path):
    """SCXviD logs of two clips at 25 fps, the destination's cuts 1.7 s
    (42.5 frames) later."""
    paths = []
    for name, cuts in (("src", [0, 50, 124, 200, 390, 610]), ("dst", [0, 92, 167, 242, 432, 652])):
        lines = ["i" if f in cuts else "p" for f in range(800)]
        path = tmp_path / f"{name}.kf.txt"
        path.write_text("# XviD 2pass stat file 1.0\n#\n#\n" + "\n".join(lines) + "\n")
        paths.append(str(path))
    return paths


def run_both(tmp_path, audio_pair, kind, extra, device_matcher, monkeypatch):
    src, dst = audio_pair
    script = str(tmp_path / f"in.{kind}")
    (make_srt if kind == "srt" else make_ass)(script, CUES if kind == "srt" else ASS_CUES)
    monkeypatch.setenv("VSE_SYNC_DEVICE", "1" if device_matcher else "0")
    outs = []
    for name, parser, runner, dev in (("port", create_arg_parser, run, ["--device", "cpu"]),
                                      ("jax", j_parser, j_run, [])):
        out = str(tmp_path / f"{name}.{kind}")
        argv = ["--src", src, "--dst", dst, "--script", script, "-o", out] + extra + dev
        assert runner(parser().parse_args(argv)) == out
        with open(out, "rb") as f:
            outs.append(f.read())
    return outs


@pytest.mark.parametrize("device_matcher", [False, True])
@pytest.mark.parametrize("grouping", [True, False])
@pytest.mark.parametrize("kind", ["srt", "ass"])
def test_runner_output_byte_equal(tmp_path, audio_pair, monkeypatch, kind, grouping,
                                  device_matcher):
    extra = [] if grouping else ["--no-grouping"]
    port, jax_out = run_both(tmp_path, audio_pair, kind, extra, device_matcher, monkeypatch)
    assert port == jax_out
    assert port.count(b"00:00:03,700" if kind == "srt" else b"0:00:03.70") == 1  # 2.0 + 1.7


@pytest.mark.parametrize("device_matcher", [False, True])
@pytest.mark.parametrize("kf_mode", ["all", "shift", "snap"])
def test_runner_with_keyframe_logs_byte_equal(tmp_path, audio_pair, monkeypatch, kf_mode,
                                              device_matcher):
    kf_src, kf_dst = keyframe_logs(tmp_path)
    extra = ["--src-keyframes", kf_src, "--dst-keyframes", kf_dst, "--src-fps", "25",
             "--dst-fps", "25", "--kf-mode", kf_mode]
    for kind in ("srt", "ass"):
        port, jax_out = run_both(tmp_path, audio_pair, kind, extra, device_matcher, monkeypatch)
        assert port == jax_out


def test_runner_checks_as_the_reference(tmp_path, audio_pair):
    src, dst = audio_pair
    script = str(tmp_path / "in.srt")
    make_srt(script, CUES)
    cases = [
        ["--src", src, "--dst", dst],  # no script for a WAV
        ["--src", src, "--dst", dst, "--script", str(tmp_path / "none.srt")],
        ["--src", src, "--dst", dst, "--script", script, "--src-fps", "25",
         "--src-timecodes", script],
        ["--src", src, "--dst", dst, "--script", script, "--src-keyframes", script],
        ["--src", src, "--dst", dst, "--script", script, "-o", str(tmp_path / "o.ass")],
        ["--src", str(tmp_path / "v.mkv"), "--dst", dst, "--script", script],
    ]
    (tmp_path / "v.mkv").write_bytes(b"")
    for argv in cases:
        msgs = []
        for parser, runner, dev in ((create_arg_parser, run, ["--device", "cpu"]),
                                    (j_parser, j_run, [])):
            with pytest.raises((common.SyncError, j_common.SyncError)) as e:
                runner(parser().parse_args(argv + dev))
            msgs.append(str(e.value))
        if not argv[1].endswith(".mkv"):
            assert msgs[0] == msgs[1], argv


def test_run_needs_cuda_unless_asked_for_cpu(tmp_path, audio_pair):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has CUDA")
    src, dst = audio_pair
    script = str(tmp_path / "in.srt")
    make_srt(script, CUES)
    args = create_arg_parser().parse_args(["--src", src, "--dst", dst, "--script", script])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(args)


def cli(*argv, env=None):
    return subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **(env or {})})


def test_cli_sync_writes_the_jax_cli_file(tmp_path, audio_pair):
    src, dst = audio_pair
    script = str(tmp_path / "in.srt")
    make_srt(script, CUES)
    outs = []
    for args in (("vse_tpu_torch.cli", "sync", "--device", "cpu"), ("vse_tpu.cli", "sync"),
                 ("vse_tpu_torch.sync.cli", "--device", "cpu"),
                 ("vse_tpu_torch.sync", "--device", "cpu")):
        out = str(tmp_path / f"{len(outs)}.srt")
        r = cli(*args, "--src", src, "--dst", dst, "--script", script, "-o", out)
        assert r.returncode == 0, r.stderr
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] == outs[2] == outs[3]
    errors = []
    for args in (("vse_tpu_torch.cli", "sync"), ("vse_tpu.cli", "sync"),
                 ("vse_tpu_torch.sync.cli",), ("vse_tpu.sync.cli",)):
        r = cli(*args, "--dst", dst, "--script", script)
        assert r.returncode == 2
        errors.append(r.stderr.strip().splitlines()[-1])
    assert len(set(errors)) == 1, errors
    assert errors[0].endswith("error: the following arguments are required: --src")


def test_cli_sync_needs_cuda_unless_asked_for_cpu(tmp_path, audio_pair):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has CUDA")
    src, dst = audio_pair
    script = str(tmp_path / "in.srt")
    make_srt(script, CUES)
    r = cli("vse_tpu_torch.cli", "sync", "--src", src, "--dst", dst, "--script", script)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert not os.path.exists(dst + ".sync.srt")


def test_sync_and_gui_import_no_jax():
    """In a fresh interpreter, the port's sync and GUI modules import none
    of jax, flax, optax, orbax or vse_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    mods = ["vse_tpu_torch.sync", "vse_tpu_torch.sync.cli", "vse_tpu_torch.sync.demux",
            "vse_tpu_torch.sync.engine", "vse_tpu_torch.sync.match", "vse_tpu_torch.sync.synth",
            "vse_tpu_torch.gui", "vse_tpu_torch.gui.server", "vse_tpu_torch.gui.runner",
            "vse_tpu_torch.gui.version", "vse_tpu_torch.gui.events", "vse_tpu_torch.cli"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vse_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# --- the regression harnesses -------------------------------------------

def test_regression_harnesses_agree(audio_pair, tmp_path):
    """``tests/test_sync.py``'s harness configs (exact expected_errors:
    one ideal event off by 0.5 s passes with 1 and fails with 0) through
    both harnesses: the same verdicts and the same error counts."""
    src, dst = audio_pair
    cues = [(2.0 + 3 * i, 4.0 + 3 * i, f"line {i}") for i in range(6)]
    make_srt(str(tmp_path / "in.srt"), cues)
    shifted = [(s + 1.7, e + 1.7, t) for s, e, t in cues]
    make_srt(str(tmp_path / "ideal.srt"), shifted)
    shifted[2] = (shifted[2][0] + 0.5, shifted[2][1] + 0.5, shifted[2][2])
    make_srt(str(tmp_path / "ideal_off.srt"), shifted)
    cfg = {"basepath": str(tmp_path), "tests": [
        {"name": f"t{i}", "src": src, "dst": dst, "script": "in.srt", "ideal": ideal,
         "fps": 23.976, "expected_errors": expected}
        for i, (ideal, expected) in enumerate(
            [("ideal.srt", 0), ("ideal_off.srt", 1), ("ideal_off.srt", 0), ("ideal.srt", 1)])],
        "wav_tests": [{"name": "w", "file": src, "max_time": 30.0}]}
    path = tmp_path / "tests.json"
    path.write_text(json.dumps(cfg))
    verdicts = []
    for tool in (["tools/sync_regression_torch.py", "--device", "cpu"],
                 ["tools/sync_regression.py"]):
        r = subprocess.run([sys.executable, tool[0], str(path), *tool[1:]], cwd=ROOT,
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ, "JAX_PLATFORMS": "cpu"})
        lines = [ln.split(":")[0] if ln.split()[1] == "wav" else ln.split(",")[0]
                 for ln in r.stdout.splitlines() if ln.startswith("[")]
        verdicts.append((r.returncode, lines))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][0] == 1 and [ln[:6] for ln in verdicts[0][1]] == \
        ["[OK] t", "[OK] t", "[FAIL]", "[FAIL]", "[OK] w"]

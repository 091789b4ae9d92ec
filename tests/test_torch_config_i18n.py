"""The port's config.json interop and message catalog against the JAX
package's, on the CPU: ``VseConfig.from_json`` / ``to_json`` on a
reference-format config, ``core/i18n.py`` (a mirror of
``tests/test_i18n.py``), and the messages the two extractors emit for the
same run under two locales."""

import dataclasses
import json
import os
import re

import numpy as np
import pytest

from vse_tpu.core import i18n as jax_i18n
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu_torch.core import i18n
from _torch_helpers import two_threads  # noqa: F401
from vse_tpu_torch.core.config import Decoder, Mode, VseConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a user's config.json in the reference's format, every key off its default
REFERENCE_CONFIG = {"Main": {
    "Language": "japan", "Mode": "fast", "GenerateTxt": True, "RecBatchNumber": 12,
    "MaxBatchSize": 4, "ExtractFrequency": 5, "TolerantPixelY": 40, "TolerantPixelX": 90,
    "SubtitleAreaDeviationPixel": 30, "WaterarkAreaNum": 3, "ThresholdTextSimilarity": 70,
    "DropScore": 60, "SubtitleAreaDeviationRate": 0.25, "DebugOcrLoss": True,
    "DebugNoDeleteCache": True, "DeleteEmptyTimeStamp": False, "WordSegmentation": False,
    "HardwareAcceleration": False, "SaveDirectory": "/data/out",
    "VideoSubFinderCpuCores": 4, "VideoSubFinderDecoder": "VideoSubFinderDecoder.FFMPEG",
    "SubtitleSelectionAreas": "0.7,0.95,0.1,0.9",
}}


def _fields(cfg) -> dict:
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("source", ["path", "dict", "section"])
def test_config_json_round_trip_matches_jax(tmp_path, source):
    """The same reference config.json gives the same fields in both
    packages (the port's are a subset of the JAX package's), and ``to_json``
    gives back the same JSON, which loads again to the same config."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(REFERENCE_CONFIG), encoding="utf-8")
    arg = {"path": str(path), "dict": REFERENCE_CONFIG, "section": REFERENCE_CONFIG["Main"]}[source]
    got, want = VseConfig.from_json(arg), JaxConfig.from_json(arg)
    theirs = _fields(want)
    for k, v in _fields(got).items():
        assert theirs[k] == v, k
    assert got.mode is Mode.FAST and got.scanner_decoder is Decoder.FFMPEG
    assert VseConfig._JSON_KEYS == JaxConfig._JSON_KEYS
    assert got.to_json() == want.to_json()
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    assert VseConfig.from_json(got.to_json()) == got
    # defaults serialise alike too
    assert VseConfig().to_json() == JaxConfig().to_json()


def test_config_replace_and_checks_match_jax():
    got = VseConfig().replace(language="en", drop_score=50)
    want = JaxConfig().replace(language="en", drop_score=50)
    assert _fields(got).items() <= _fields(want).items()
    for bad in ({"rec_batch_number": 0}, {"max_batch_size": 300}, {"drop_score": 101}):
        with pytest.raises(ValueError):
            VseConfig(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad)


def test_tr_formats_and_falls_back():
    i18n.set_locale("en")
    assert "42" in i18n.tr("ResumeFrom", 42, 7)
    assert i18n.tr("NoSuchKey") == "NoSuchKey"
    assert i18n.tr("ResumeFrom", 42, 7) == jax_i18n.tr("ResumeFrom", 42, 7)


def test_locale_switch_translates_pipeline_messages(tmp_path):
    ini = tmp_path / "de.ini"
    ini.write_text("[Main]\nExtractionDone = Extraktion fertig in {0}s -> {1}\n",
                   encoding="utf-8")
    try:
        i18n.set_locale("de", str(ini))
        assert i18n.get_locale() == "de"
        assert i18n.tr("ExtractionDone", "1.0", "/x.srt").startswith("Extraktion fertig")
        assert "resuming" in i18n.tr("ResumeFrom", 1, 2)  # English fallback
    finally:
        i18n.set_locale("en")


def test_bundled_locales_are_the_jax_packages():
    """The port's eight catalogs are byte copies of the JAX package's and
    translate every pipeline key."""
    assert i18n.available_locales() == jax_i18n.available_locales()
    assert set(i18n.available_locales()) >= {
        "ch", "chinese_cht", "en", "es", "japan", "ko", "tr", "vi"}
    assert i18n._EN == jax_i18n._EN
    for loc in i18n.available_locales():
        name = f"{loc}.ini"
        with open(os.path.join(ROOT, "vse_tpu", "assets", "locales", name), "rb") as f:
            want = f.read()
        with open(os.path.join(i18n._locales_dir(), name), "rb") as f:
            assert f.read() == want, loc
        cat = i18n._load_ini(os.path.join(i18n._locales_dir(), name))
        assert not set(i18n._EN) - set(cat), loc


@pytest.mark.parametrize("locale", ["ch", "japan", "es"])
def test_bundled_locale_switch_matches_jax(locale):
    try:
        i18n.set_locale(locale)
        jax_i18n.set_locale(locale)
        for key in i18n._EN:
            assert i18n.tr(key, "A", "B", "C") == jax_i18n.tr(key, "A", "B", "C")
            assert i18n.tr(key, "A", "B", "C") != key
        assert "/x.srt" in i18n.tr("SubLocation", "/x.srt")
    finally:
        i18n.set_locale("en")
        jax_i18n.set_locale("en")


class _NullEngine:
    """No text on any frame (both packages' engine contracts)."""

    family = "en"

    class spec:  # noqa: N801 — the JAX engine's attribute
        rec_family = "en"

    def predict_batch(self, frames, origin=(0, 0)):
        return [([], []) for _ in range(len(frames))]


def _run_both(tmp_path, locale, ini=None):
    """(port messages, JAX messages) of one fps run on a 10-frame clip
    with a text-free engine, the elapsed seconds masked."""
    cv2 = pytest.importorskip("cv2")
    from vse_tpu.core.config import Mode as JaxMode
    from vse_tpu.pipeline.extractor import SubtitleExtractor as JaxExtractor
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor

    video = str(tmp_path / "v.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (64, 48))
    for _ in range(10):
        vw.write(np.zeros((48, 64, 3), np.uint8))
    vw.release()
    msgs = []
    for ex in (
        SubtitleExtractor(video, None, VseConfig(language="en", word_segmentation=False),
                          engine=_NullEngine(), device="cpu"),
        JaxExtractor(video, config=JaxConfig(language="en", mode=JaxMode.FAST,
                                             word_segmentation=False), engine=_NullEngine()),
    ):
        out = []
        ex.append_output = lambda *a, out=out: out.append(" ".join(str(x) for x in a))
        ex.subtitle_output_path = str(tmp_path / "o.srt")
        try:
            i18n.set_locale(locale, ini)
            jax_i18n.set_locale(locale, ini)
            ex.run()
        finally:
            i18n.set_locale("en")
            jax_i18n.set_locale("en")
        msgs.append([re.sub(r"\d+\.\d", "S", m) for m in out])
    return msgs


@pytest.mark.parametrize("locale", ["en", "ch"])
def test_extractor_messages_match_jax(tmp_path, locale):
    """The port's extractor emits, through ``append_output``, the same
    catalog messages as the JAX extractor for the same run."""
    got, want = _run_both(tmp_path, locale)
    assert got == want and len(got) == 2, (got, want)
    assert got[1] == i18n.tr("SubLocation", str(tmp_path / "o.srt")) or locale != "en"


def test_extractor_emits_catalog_message(tmp_path):
    ini = tmp_path / "xx.ini"
    ini.write_text("[Main]\nExtractionDone = FERTIG {0} {1}\n", encoding="utf-8")
    got, want = _run_both(tmp_path, "xx", str(ini))
    assert got == want
    assert any(m.startswith("FERTIG") for m in got), got


def test_cli_config_gives_the_jax_clis_srt(tmp_path):
    """The same reference-format config.json (language en, no word
    segmentation, a lower drop score, a .txt transcript) through
    ``vse_tpu.cli extract --config`` and the port's CLI gives the same SRT
    and transcript on a tiny lossless clip (keyframe strategy)."""
    cv2 = pytest.importorskip("cv2")
    from vse_tpu.cli import main as jax_main
    from vse_tpu_torch import cli
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    bands, _ = load_fixture()
    frames = compose_frames(bands, {
        "width": 1280, "height": 240, "fps": 25, "n_frames": 56,
        "background": [30, 40, 60], "band_origin": [120, 0],
        "cues": [{"band": "band1", "first": 4, "last": 26},
                 {"band": "band2", "first": 32, "last": 54}]})
    clip = str(tmp_path / "tiny.avi")
    vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 240))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"Main": {"Language": "en", "WordSegmentation": False,
                                        "DropScore": 70, "GenerateTxt": True}}),
                   encoding="utf-8")
    common = ["extract", clip, "--config", str(cfg), "--area", "120,224,0,1280"]
    assert jax_main(common + ["--output", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    for name in ("tiny.srt", "tiny.txt"):
        want = (tmp_path / "jax" / name).read_text(encoding="utf-8")
        assert (tmp_path / "port" / name).read_text(encoding="utf-8") == want, name
    assert want.count("\n") >= 2

"""The default language, ch, in the port against the JAX package, on the CPU:
its charset and script families, the copy of its dict file, the bf16 export
of its 21,060-class head, the emulated CRNN against flax's bf16 CRNN, the
OCR engine against the JAX engine, and the CLI's default language.

Memory: a ch OCR chunk of 8 frames holds 64 crops x 80 steps x 21,060 f32
logits (431 MB) and the emulation's copies of them. Engines here OCR in
chunks of 2 frames (``max_batch_size=2``: 16 crops, 108 MB of logits). The
SRTs of the two ch clips are held in
``tests/test_torch_ch_keyframe_e2e.py`` and ``tests/test_torch_ch_fps_e2e.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from vse_tpu.core import charset as jax_charset
from vse_tpu.core.config import LANGUAGES
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.registry import init_or_load, models_root
from vse_tpu.models.crnn import CRNNRecognizer as FlaxCRNN
from vse_tpu.pipeline import extractor as jax_extractor
from vse_tpu.pipeline.ocr_engine import OcrEngine as JaxEngine
from _torch_helpers import two_threads  # noqa: F401
from vse_tpu_torch import cli
from vse_tpu_torch.core import charset
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.models import bf16 as B16
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.pipeline import extractor
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.video.synth import compose_frames, load_fixture
from vse_tpu_torch.weights import from_jax_params, load_rec_flat, rec_head_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH_CLASSES = 21060


def test_ch_charset_and_families_match_jax():
    got, want = charset.get_charset("ch"), jax_charset.get_charset("ch")
    assert got.chars == want.chars
    assert got.without_space().chars == want.without_space().chars
    assert got.without_space().vocab_size == 21059
    ids = range(0, 21101)
    for g, w in ((got, want), (got.without_space(), want.without_space())):
        assert g.decode_ids(ids) == w.decode_ids(ids)
    assert len(LANGUAGES) >= 87
    for lang in LANGUAGES:
        assert charset.script_family(lang) == jax_charset.script_family(lang), lang
    # a family that is not ported yet raises and names the family
    for lang, family in (("japan", "japan"), ("chinese_cht", "chinese_cht")):
        with pytest.raises(NotImplementedError, match=repr(family)):
            charset.get_charset(lang)


def test_charset_from_file_keeps_a_space_line(tmp_path):
    path = tmp_path / "d.txt"
    path.write_bytes("a\r\n \n\nb\n".encode())
    got = charset.Charset.from_file("x", str(path), use_space_char=False)
    want = jax_charset.Charset.from_file("x", str(path), use_space_char=False)
    assert got.chars == want.chars == ("a", " ", "b")


def test_dict_copy_is_byte_equal():
    with open(os.path.join(ROOT, "vse_tpu", "assets", "dicts", "ch.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(charset.DICT_DIR, "ch.txt"), "rb") as f:
        assert f.read() == want
    assert len(want) == 84048


def test_bf16_export_is_lossless_through_emulate():
    """The CRNN built from the orbax f32 params and the one built from the
    bf16-stored npz have bit-equal state dicts once both are emulated."""
    flax_model = FlaxCRNN(vocab_size=21059)
    variables, loaded = init_or_load(flax_model, jnp.zeros((1, 48, 320, 3)),
                                     os.path.join(models_root(), "rec_ch_mobile"))
    assert loaded
    orbax = {"/".join(k): np.asarray(v, np.float32) for k, v in flatten_dict(variables).items()}
    npz = load_rec_flat("ch")
    assert sorted(npz) == sorted(orbax)
    assert npz["params/ctc_fc/kernel"].shape == (96, CH_CLASSES)
    assert npz["params/ctc_fc/kernel"].dtype == np.float32
    models = []
    for flat in (orbax, npz):
        m = CRNNRecognizer(21059)
        m.load_state_dict(from_jax_params(flat), strict=True)
        models.append(B16.emulate(m).state_dict())
    for k in models[0]:
        assert torch.equal(models[0][k], models[1][k]), k
    # BatchNorm stays f32: its arrays are stored as they were
    bn = [k for k in orbax if "BatchNorm_" in k]
    assert bn and all(np.array_equal(orbax[k], npz[k]) for k in bn)
    assert os.path.getsize(rec_head_paths("ch")[0]) < 5_000_000


def rendered_crops() -> np.ndarray:
    """The three ch cue bands, each cut to its text line plus a margin and
    resized to the rec input (48 x 320), normalized to [-1, 1], and a
    second copy of each shifted by 3 px: [6, 48, 320, 3]."""
    bands, _ = load_fixture(recipe="recipe_ch.json")
    crops = []
    for shift in (0, 3):
        for name in ("band0", "band1", "band2"):
            b = bands[name]
            ink = np.nonzero((b.max(-1) > 120).any(0))[0]
            x0, x1 = max(0, ink[0] - 12 + shift), min(b.shape[1], ink[-1] + 12 + shift)
            t = torch.from_numpy(b[18:86, x0:x1].astype(np.float32)).permute(2, 0, 1)[None]
            t = torch.nn.functional.interpolate(t, size=(48, 320), mode="bilinear",
                                                align_corners=False)
            crops.append(t[0].permute(1, 2, 0).numpy() / 127.5 - 1.0)
    return np.stack(crops).astype(np.float32)


def test_ch_crnn_emulation_matches_flax_bf16_on_rendered_crops():
    """Same argmax on every step of every crop. Share of bit-equal logits:
    at least 3/4, as for the en head (measured 0.776 on these crops; en
    0.80). The f32 sums of the convolutions and the LSTM's transcendentals
    differ in order and in the last bits, which flips a bf16 rounding now
    and then, and the LSTM carries a flip along. The ch head's logits are
    twice as large as en's (mean magnitude 16.4 against 8.6), so the mean
    absolute difference is bounded relative to them: under 0.2% of the mean
    magnitude (measured 0.12%; en 0.085%, where the en test's bound of 0.01
    is 0.12%)."""
    flat = load_rec_flat("ch")
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(a) for k, a in flat.items()})
    x = rendered_crops()
    ref = np.asarray(jax.jit(FlaxCRNN(vocab_size=21059).apply)(tree, jnp.asarray(x)))
    m = CRNNRecognizer(21059)
    m.load_state_dict(from_jax_params(flat), strict=True)
    with torch.no_grad():
        got = B16.emulate(m).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (6, 80, CH_CLASSES)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert (got.argmax(-1) > 0).sum() >= 20  # the crops read as text
    d = np.abs(got - ref)
    assert (d == 0).mean() >= 0.75
    assert d.mean() < 0.002 * np.abs(ref).mean()


@pytest.fixture(scope="module")
def frames():
    """Eight full frames of the ch no-area clip: cues, watermark, sign."""
    bands, recipe = load_fixture(recipe="recipe_ch_fps_short.json")
    return compose_frames(bands, recipe)[[32, 56, 176, 208, 216, 224, 352, 400]]


def test_ch_engine_reads_what_the_jax_engine_reads(frames):
    """Texts and boxes exact on full 720p frames (letterboxed into the 576 x
    960 det bucket). A line's score is the mean over its kept steps of the
    top class's softmax probability over 21,060 classes, and the emulated
    logits differ from flax's by up to 1.4 where the LSTM carries a flipped
    bf16 rounding (``test_ch_crnn_emulation_matches_flax_bf16_on_rendered_crops``):
    scores within 0.005 (0.07 while the crops' ``48 / bh`` was a reciprocal
    multiply, ROADMAP fault 10, and the static watermark's garbage read was
    0.055 off), and on the same side of the area gate's ``drop_score``
    (0.75) as the JAX engine's."""
    port = OcrEngine("ch", config=VseConfig(language="ch", max_batch_size=2), device="cpu")
    assert port.family == "ch" and port.charset.vocab_size + 1 == CH_CLASSES
    assert port.rec_model.ctc_fc.out_features == CH_CLASSES
    ref_engine = JaxEngine("ch", config=JaxConfig(language="ch", max_batch_size=2))
    got = port.predict_batch(frames)
    ref = ref_engine.predict_batch(frames)
    texts = [t for _, res in got for t, _ in res]
    assert {"我们明天见", "你好世界"} <= set(texts)
    for (g_box, g_res), (r_box, r_res) in zip(got, ref):
        assert [t for t, _ in g_res] == [t for t, _ in r_res]
        assert g_box == r_box
        g_p, r_p = np.array([p for _, p in g_res]), np.array([p for _, p in r_res])
        np.testing.assert_allclose(g_p, r_p, atol=0.005)
        assert np.array_equal(g_p > 0.75, r_p > 0.75)


def test_to_logical_is_the_identity_for_ch_and_raises_for_unported_passes():
    eng = OcrEngine.__new__(OcrEngine)
    eng.family = "ch"
    assert eng._to_logical("你好世界") == "你好世界"
    # the arabic, cyrillic and el passes are ported: each is the JAX
    # package's (tests/test_torch_scripts.py holds them on drawn strings)
    from vse_tpu.core.arabic import visual_to_logical
    from vse_tpu.post.homoglyph import normalize_script

    for family, text in (("arabic", "مرحبا 123"), ("cyrillic", "пpивeт"), ("el", "Kαλo")):
        eng.family = family
        want = visual_to_logical(text) if family == "arabic" else normalize_script(text, family)
        assert eng._to_logical(text) == want != text
        assert eng._to_logical("") == ""


def test_cli_default_language_is_the_configs_as_in_jax(monkeypatch, tmp_path):
    """``extract VIDEO`` with no ``--language`` builds a ch engine in both
    packages (each package's ``SubtitleExtractor.run`` is stubbed)."""
    cv2 = pytest.importorskip("cv2")
    video = tmp_path / "v.avi"
    vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (64, 48))
    for _ in range(2):
        vw.write(np.zeros((48, 64, 3), np.uint8))
    vw.release()
    seen = {}

    def port_run(self):
        seen["port"] = (self.config.language, self.engine.language, self.engine.family,
                        self.engine.rec_model.ctc_fc.out_features)
        return "port.srt"

    def jax_run(self):
        seen["jax"] = self.config.language
        return "jax.srt"

    monkeypatch.setattr(extractor.SubtitleExtractor, "run", port_run)
    monkeypatch.setattr(jax_extractor.SubtitleExtractor, "run", jax_run)
    from vse_tpu.cli import main as jax_main

    assert cli.main(["extract", str(video), "--device", "cpu"]) == 0
    assert jax_main(["extract", str(video)]) == 0
    assert seen["port"] == ("ch", "ch", "ch", CH_CLASSES)
    assert seen["jax"] == "ch" == JaxConfig().language == VseConfig().language
    assert cli.main(["extract", str(video), "--language", "en", "--device", "cpu"]) == 0
    assert seen["port"][:3] == ("en", "en", "en")

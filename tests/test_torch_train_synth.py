"""The port's training renderer (``vse_tpu_torch/train/synth.py``,
``wordlists.py``, the render halves of ``core/hangul.py`` and
``core/arabic.py``) against the JAX package's: the same seed draws the same
pixels (byte-equal) and the same texts and labels."""

import os
import subprocess
import sys

import numpy as np
import pytest

from vse_tpu.core.charset import get_charset as jax_charset
from vse_tpu.core.charset import to_jamo as jax_to_jamo
from vse_tpu.train import pretrain as jax_pretrain
from vse_tpu.train import synth as js
from vse_tpu.train import wordlists as jw
from vse_tpu_torch.core.charset import get_charset
from vse_tpu_torch.train import pretrain
from vse_tpu_torch.train import synth as ts
from vse_tpu_torch.train import wordlists as tw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_en_rec_crops_are_byte_equal():
    """16 ``render_line`` crops of the rec profile (``rec_render_config``)
    for the en training charset, seed 0, difficulty rising as in the
    dataset's curriculum."""
    jr = js.TextRenderer(jax_pretrain._rec_train_charset("en", False, True),
                         js.rec_render_config(), seed=0)
    tr = ts.TextRenderer(pretrain._rec_train_charset("en", False, True),
                         ts.rec_render_config(), seed=0)
    for i in range(16):
        jr.cfg.difficulty = tr.cfg.difficulty = min(1.0, 2.0 * i / 16)
        a, ta = jr.render_line()
        b, tb = tr.render_line()
        assert ta == tb and a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), i


@pytest.mark.parametrize("language", ["en", "ar", "korean", "ru", "el", "ka", "fr"])
def test_rec_batches_equal_with_their_labels(language):
    """``rec_batch``: images, labels (each charset's ``encode``: case fold,
    homoglyph aliases, positional jamo), lengths and texts equal."""
    jb = js.TextRenderer(jax_pretrain._rec_train_charset(language, False, True),
                         js.rec_render_config(), seed=1).rec_batch(3)
    tb = ts.TextRenderer(pretrain._rec_train_charset(language, False, True),
                         ts.rec_render_config(), seed=1).rec_batch(3)
    assert jb["texts"] == tb["texts"]
    for k in ("rec_images", "labels", "label_lengths"):
        assert np.array_equal(jb[k], tb[k]), k


def test_training_charsets_match_the_jax_package():
    for language in ("en", "fr", "ru", "el", "ar", "korean", "ka", "hi", "th", "ch"):
        j = jax_pretrain._rec_train_charset(language, False, True)
        t = pretrain._rec_train_charset(language, False, True)
        assert (j.chars, j.use_space_char, j.fold_case, j.aliases) == (
            t.chars, t.use_space_char, t.fold_case, t.aliases), language
        for text in ("Hello World 42", "مرحبا ١٢٣ ە ی", "한국어 ㅋㅋ ㄳ", "Привет мир", "ถ้า"):
            assert j.encode(text) == t.encode(text), (language, text)
    assert jax_pretrain._rec_train_charset("korean", False, True).render_chars == (
        pretrain._rec_train_charset("korean", False, True).render_chars)
    assert jax_to_jamo(jax_charset("korean")).render_chars == get_charset("korean").chars


def test_det_frames_and_labels_are_equal():
    """4 ``render_frame`` frames (256 x 448) with their boxes and the four
    DB label maps of ``det_labels``; ``det_batch`` and ``combined_batch``."""
    jr = js.TextRenderer(jax_charset("en"), js.SynthConfig(), seed=0)
    tr = ts.TextRenderer(get_charset("en"), ts.SynthConfig(), seed=0)
    for _ in range(4):
        a, ba = jr.render_frame()
        b, bb = tr.render_frame()
        assert ba == bb and np.array_equal(a, b)
        la, lb = jr.det_labels(ba), tr.det_labels(bb)
        assert la.keys() == lb.keys()
        assert all(np.array_equal(la[k], lb[k]) for k in la)
    cfg = dict(det_h=64, det_w=128, rec_w=160)
    ja = js.TextRenderer(jax_charset("en"), js.SynthConfig(**cfg), seed=4).combined_batch(2)
    tb = ts.TextRenderer(get_charset("en"), ts.SynthConfig(**cfg), seed=4).combined_batch(2)
    assert ja.keys() == tb.keys()
    assert all(np.array_equal(ja[k], tb[k]) for k in ja)


def test_the_dataset_renderer_matches_the_jax_loader():
    """``pretrain.render_rec_dataset`` draws ``load_or_render_rec_dataset``'s
    crops: the curriculum's difficulty rises to 1 by the middle."""
    imgs, texts = pretrain.render_rec_dataset("en", 6, seed=2)
    r = js.TextRenderer(jax_pretrain._rec_train_charset("en", False, True),
                        js.rec_render_config(), seed=2)
    for bi in range(6):
        r.cfg.difficulty = min(1.0, 2.0 * bi / 6)
        img, text = r.render_line()
        assert text == texts[bi] and np.array_equal(img, imgs[bi])


@pytest.mark.parametrize("language", ["th", "hi", "ta", "te", "ch", "japan", "chinese_cht"])
def test_stroke_families_are_refused_by_name(language):
    """The stroke families were refused by name until their renderers
    (``core/strokefont.py`` and its script modules) were ported; now each
    draws from its stroke script, byte-equal to the JAX renderer
    (``tests/test_torch_renderers.py``)."""
    cs = get_charset(language)
    r = ts.TextRenderer(cs, ts.rec_render_config())
    assert cs.name in ts.STROKE_FAMILIES and r._stroke is not None
    img, text = r.render_line()
    assert img.shape == (48, 320, 3) and text


def test_wordlists_are_a_copy():
    assert tw.NATIVE_WORDS == jw.NATIVE_WORDS


def test_training_modules_import_without_pil_cv2_matplotlib_fonttools_or_jax():
    """A machine that trains on the card may have none of them: with all
    of them blocked, every training module imports, and none pulls in jax,
    optax, flax or vse_tpu."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'cv2', 'matplotlib', 'fontTools', 'jax', 'optax', 'flax', 'vse_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import vse_tpu_torch.train.optim, vse_tpu_torch.train.losses\n"
        "import vse_tpu_torch.train.synth, vse_tpu_torch.train.wordlists\n"
        "import vse_tpu_torch.train.device_loop, vse_tpu_torch.train.pretrain\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'flax', 'vse_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

"""The port's stroke and CJK training renderers (``vse_tpu_torch/core/``:
``strokefont``, ``thai``, ``devanagari``, ``tamil``, ``telugu``, ``kana``,
``cjk_ids``, ``cjk_components``, ``cjk``) against the JAX package's: the
same glyph tables, the same figure lists from ``compose_line``, and
``TextRenderer`` drawing th, devanagari, ta, te, ch, chinese_cht and japan
byte for byte."""

import numpy as np
import pytest

from vse_tpu.core.config import LANGUAGES as ALL_CODES
from vse_tpu.core import strokefont as jsf
from vse_tpu.train import pretrain as jax_pretrain
from vse_tpu.train import synth as js
from vse_tpu_torch.core import charset
from vse_tpu_torch.core import strokefont as tsf
from vse_tpu_torch.train import pretrain
from vse_tpu_torch.train import synth as ts

# a language of each stroke family
LANGUAGES = {"th": "th", "devanagari": "hi", "ta": "ta", "te": "te", "ch": "ch",
             "chinese_cht": "chinese_cht", "japan": "japan"}


def test_stroke_families_are_the_jax_packages():
    families = sorted({charset.script_family(code) for code in ALL_CODES}
                      | set(LANGUAGES))
    stroke = [f for f in families if jsf.stroke_script_for(f) is not None]
    assert sorted(stroke) == sorted(ts.STROKE_FAMILIES) == sorted(LANGUAGES)
    assert all(tsf.stroke_script_for(f) is None for f in families if f not in stroke)


def test_max_label_len_is_36_exactly_where_jax_draws_strokes():
    """``rec_train_config``'s label length against the JAX package's rule
    (36 where ``stroke_script_for`` has a script, 56 for jamo, else 24), for
    every language's training charset."""
    for code in sorted(ALL_CODES):
        family = charset.script_family(code)
        if family == "korean":
            continue  # jamo: 56, tests/test_torch_train_synth.py
        t = pretrain._rec_train_charset(code, False, True)
        j = jax_pretrain._rec_train_charset(code, False, True)
        want = 36 if jsf.stroke_script_for(j.name) is not None else 24
        assert pretrain.rec_train_config(t).max_label_len == want, code


def figures(script, text):
    """``compose_line``'s output as plain data: each figure's points (or
    ellipse box) and kind, and the advance."""
    compose = tsf.compose_line if isinstance(script, tsf.StrokeScript) else jsf.compose_line
    figs, adv = compose(script, text)
    return [(np.asarray(f, dtype=np.float64).round(12).tolist(), e) for f, e in figs], adv


@pytest.mark.parametrize("family", sorted(LANGUAGES))
def test_compose_line_figures_equal_jax(family):
    """The glyph tables are the same, and ``compose_line`` gives the same
    figure list for texts drawn by the JAX renderer and for every base
    and mark of the script's own table (a sample for the CJK sets)."""
    j, t = jsf.stroke_script_for(family), tsf.stroke_script_for(family)
    assert sorted(j.marks) == sorted(t.marks)
    assert (j.base_band, j.headline_y, j.ligatures, j.common_marks) == \
        (t.base_band, t.headline_y, t.ligatures, t.common_marks)
    bases = sorted(c for c in j.glyphs)[:600] if hasattr(j.glyphs, "keys") else None
    if bases is None:  # the composed CJK table: its coverable characters
        bases = [c for c in jax_pretrain._rec_train_charset(LANGUAGES[family], False, True).chars
                 if j.covers(c)][:: 40][:400]
    texts = ["".join(bases[i:i + 7]) for i in range(0, len(bases), 7)]
    texts += ["".join(sorted(j.marks)[i:i + 3]) for i in range(0, len(j.marks), 3)]
    r = js.TextRenderer(jax_pretrain._rec_train_charset(LANGUAGES[family], False, True),
                        js.rec_render_config(), seed=5)
    texts += [r.random_text() for _ in range(20)]
    for text in texts:
        assert figures(t, text) == figures(j, text), (family, text)


@pytest.mark.parametrize("family", sorted(LANGUAGES))
def test_batches_are_byte_equal(family):
    """``rec_batch`` (crops, texts, labels, lengths) and ``det_batch``
    (frames, label maps, boxes) from the same seed."""
    lang = LANGUAGES[family]
    jr = js.TextRenderer(jax_pretrain._rec_train_charset(lang, False, True),
                         js.rec_render_config(), seed=3)
    tr = ts.TextRenderer(pretrain._rec_train_charset(lang, False, True),
                         ts.rec_render_config(), seed=3)
    for difficulty in (0.2, 1.0):
        jr.cfg.difficulty = tr.cfg.difficulty = difficulty
        jb, tb = jr.rec_batch(3), tr.rec_batch(3)
        assert jb["texts"] == tb["texts"]
        for k in ("rec_images", "labels", "label_lengths"):
            assert np.array_equal(jb[k], tb[k]), (family, k)
    jd, td = jr.det_batch(1), tr.det_batch(1)
    assert sorted(jd) == sorted(td)
    for k in jd:
        if isinstance(jd[k], np.ndarray):
            assert np.array_equal(jd[k], td[k]), (family, k)
        else:
            assert jd[k] == td[k], (family, k)

"""The port's SRT scorer (``vse_tpu_torch/eval.py``) against the JAX
package's ``vse_tpu/eval.py``: the same SRT pairs give the same
``EvalResult``, every float bit-equal (host code on both sides)."""

import glob
import itertools
import os

from hypothesis import given, settings
from hypothesis import strategies as st

from vse_tpu import eval as jax_eval
from vse_tpu.post.srt import SrtFile as JaxSrt
from vse_tpu_torch import eval as port_eval
from vse_tpu_torch.post.srt import SrtFile, SrtItem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "vse_tpu_torch", "assets", "smoke")
REFS = sorted(glob.glob(os.path.join(SMOKE, "reference*.srt")))
FIELDS = ("precision", "recall", "f1", "cer", "matched", "n_ref", "n_pred", "edit_dist",
          "ref_chars")


def same(a, b) -> bool:
    """Every field equal, floats bit for bit."""
    return all(repr(getattr(a, f)) == repr(getattr(b, f)) for f in FIELDS) and \
        a.as_dict() == b.as_dict()


def both(pred_text: str, ref_text: str, **kw):
    return (port_eval.evaluate_srt(SrtFile.loads(pred_text), SrtFile.loads(ref_text), **kw),
            jax_eval.evaluate_srt(JaxSrt.loads(pred_text), JaxSrt.loads(ref_text), **kw))


def test_smoke_references_score_as_in_jax():
    """Every ordered pair of the committed reference SRTs (en, ch, the fps
    and short-cue clips), files through ``evaluate_files``; a file against
    itself scores F1 1 and CER 0; the corpus ``micro_average`` equal."""
    assert len(REFS) >= 6
    ours, theirs = [], []
    for pred, ref in itertools.product(REFS, REFS):
        a = port_eval.evaluate_files(pred, ref)
        b = jax_eval.evaluate_files(pred, ref)
        assert same(a, b), (pred, ref)
        if pred == ref:
            assert a.f1 == 1.0 and a.cer == 0.0
        ours.append(a)
        theirs.append(b)
    assert same(port_eval.micro_average(ours), jax_eval.micro_average(theirs))
    assert same(port_eval.micro_average([]), jax_eval.micro_average([]))


def test_helpers_equal_jax():
    for t in ("  Hello\tWORLD  ", "ｆｕｌｌ　ｗｉｄｔｈ", "你好 世界", ""):
        assert port_eval.normalize_text(t) == jax_eval.normalize_text(t)
    for a, b in (("kitten", "sitting"), ("", "abc"), ("abc", ""), ("你好世界", "你们世界")):
        assert port_eval._edit_distance(a, b) == jax_eval._edit_distance(a, b)
    for args in ((0, 10, 5, 15), (0, 10, 10, 20), (5, 5, 0, 10), (0, 1000, 0, 1000)):
        assert repr(port_eval.time_iou(*args)) == repr(jax_eval.time_iou(*args))


def reference_cues():
    return [(i.start_ms, i.end_ms, i.text) for p in REFS for i in SrtFile.open(p)]


@st.composite
def perturbed_pair(draw):
    """A reference script of committed cues and a prediction made from it
    by dropping cues, shifting timings and editing text."""
    pool = reference_cues()
    ref = draw(st.lists(st.sampled_from(pool), min_size=0, max_size=8))
    pred = []
    for start, end, text in ref:
        if draw(st.booleans()) and draw(st.booleans()):
            continue  # dropped
        shift = draw(st.integers(-800, 800))
        stretch = draw(st.integers(-300, 300))
        if draw(st.booleans()) and text:
            i = draw(st.integers(0, len(text) - 1))
            text = text[:i] + draw(st.text(min_size=0, max_size=3)) + text[i + 1:]
        pred.append((max(0, start + shift), max(0, end + shift + stretch), text))
    if draw(st.booleans()):
        pred.append((draw(st.integers(0, 20000)), draw(st.integers(0, 20000)),
                     draw(st.text(max_size=12))))

    def srt(cues):
        return SrtFile([SrtItem(i + 1, s, e, t) for i, (s, e, t) in enumerate(cues)]).dumps()

    return srt(pred), srt(ref)


@settings(max_examples=150, deadline=None)
@given(pair=perturbed_pair(), iou=st.sampled_from([0.0, 0.3, 0.6]),
       sim=st.sampled_from([0.5, 0.8, 1.0]))
def test_perturbed_pairs_score_as_in_jax(pair, iou, sim):
    pred, ref = pair
    a, b = both(pred, ref, iou_thresh=iou, sim_thresh=sim)
    assert same(a, b)

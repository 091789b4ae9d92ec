"""The ten non-CJK script families in the port against the JAX package, on
the CPU: the decode passes (positional-jamo recomposition, arabic visual ->
logical order, the cyrillic and greek homoglyph fold) on drawn strings, the
language -> family -> head charset resolution for every language of the
JAX package's ``LANGUAGES``, the dict copies, the bf16 export of each head,
and the rec crop on the box where the port's crop once differed from the
JAX engine's (ROADMAP fault 10).

The end-to-end runs of the families are in ``tests/test_torch_scripts_e2e_*.py``.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from vse_tpu.core import charset as jax_charset
from vse_tpu.core.arabic import visual_to_logical as jax_visual_to_logical
from vse_tpu.core.config import LANGUAGES
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.registry import load_params, models_root
from vse_tpu.models.crnn import CRNNRecognizer as FlaxCRNN
from vse_tpu.ops.image import crop_axis_aligned_matmul_windowed
from vse_tpu.pipeline.ocr_engine import OcrEngine as JaxEngine
from vse_tpu.post.homoglyph import normalize_script as jax_normalize_script
from vse_tpu_torch.core import charset
from vse_tpu_torch.core.arabic import visual_to_logical
from vse_tpu_torch.models import bf16 as B16
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.ops.image import crop_boxes_windowed
from vse_tpu_torch.pipeline.ocr_engine import head_charset
from vse_tpu_torch.post.homoglyph import normalize_script
from vse_tpu_torch.video.synth import compose_frames, load_fixture
from vse_tpu_torch.weights import from_jax_params, load_rec_flat, load_rec_meta, rec_head_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("latin", "cyrillic", "devanagari", "arabic", "korean", "el", "ta", "te",
            "ka", "th")
# each head's class count with the blank (the vocab_size of its
# vse_meta.json, plus one)
CLASSES = {"ta": 83, "th": 98, "ka": 99, "te": 111, "devanagari": 139, "el": 147,
           "korean": 162, "cyrillic": 201, "latin": 293, "arabic": 298}
# the CJK heads' class counts with the blank, and the families with a
# head of 21k classes
CJK_CLASSES = {"ch": 21060, "japan": 21249, "chinese_cht": 21060}


def jax_engine_charset(language):
    """The charset the JAX engine builds for ``language`` from its head's
    vse_meta.json (the engine itself, with no weights loaded)."""
    return JaxEngine(language, config=JaxConfig(language=language),
                     det_params={}, rec_params={}).charset


@pytest.mark.parametrize("family", FAMILIES)
def test_dict_copy_is_byte_equal(family):
    with open(os.path.join(ROOT, "vse_tpu", "assets", "dicts", f"{family}.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(charset.DICT_DIR, f"{family}.txt"), "rb") as f:
        assert f.read() == want


def test_every_language_resolves_as_in_the_jax_engine():
    """For each of the 89 codes: the script family, and the head charset
    after the head's metas (its characters, their order and C) equal the
    JAX engine's, all 89 of them."""
    assert len(LANGUAGES) == 89
    families = {}
    for lang in LANGUAGES:
        family = charset.script_family(lang)
        assert family == jax_charset.script_family(lang), lang
        families.setdefault(family, []).append(lang)
        got = head_charset(lang, load_rec_meta(family))
        want = jax_engine_charset(lang)
        assert got.chars == want.chars, lang
        assert type(got).__name__ == type(want).__name__, lang
        if family in CLASSES:
            assert got.vocab_size + 1 == CLASSES[family], lang
        if family in CJK_CLASSES:
            assert got.vocab_size + 1 == CJK_CLASSES[family], lang
    assert sum(len(families[f]) for f in FAMILIES) == 85
    assert {f: len(families[f]) for f in ("latin", "cyrillic", "devanagari", "arabic")} == {
        "latin": 43, "cyrillic": 17, "devanagari": 14, "arabic": 5}


def test_charset_variants_match_jax():
    """``aliased`` and ``without_space`` keep the JAX package's classes and
    aliases; ``to_jamo`` gives its 67 positional classes beside the
    non-Hangul ones, with and without the space class."""
    from vse_tpu.core.arabic import HOMOGLYPHS as JAX_HOMOGLYPHS
    from vse_tpu_torch.core.arabic import HOMOGLYPHS

    assert HOMOGLYPHS == JAX_HOMOGLYPHS
    got = charset.get_charset("ar").aliased(HOMOGLYPHS)
    want = jax_charset.get_charset("ar").aliased(JAX_HOMOGLYPHS)
    for g, w in ((got, want), (got.without_space(), want.without_space())):
        assert g.chars == w.chars and g.aliases == w.aliases
    assert not set(HOMOGLYPHS) & set(got.chars)
    jamo = charset.to_jamo(charset.get_charset("korean"))
    want = jax_charset.to_jamo(jax_charset.get_charset("korean"))
    assert jamo.chars == want.chars and jamo.use_space_char == want.use_space_char
    jamo = charset.to_jamo(charset.get_charset("korean").without_space())
    want = jax_charset.to_jamo(jax_charset.get_charset("korean").without_space())
    assert jamo.chars == want.chars and jamo.vocab_size == want.vocab_size == 161


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_jamo_decode_matches_jax(data):
    """Any id run (blanks, out-of-range ids, lone and stray jamo, finals
    with no syllable) decodes to the JAX package's text."""
    got = head_charset("korean", load_rec_meta("korean"))
    want = jax_engine_charset("korean")
    n = got.vocab_size
    # ids biased to the jamo blocks, where the recomposition happens
    jamo = list(range(n - 66, n + 1))
    ids = data.draw(st.lists(st.one_of(st.integers(-1, n + 2), st.sampled_from(jamo)),
                             max_size=40))
    assert got.decode_ids(ids) == want.decode_ids(ids)


def test_jamo_decode_recomposes_words():
    cs = head_charset("korean", load_rec_meta("korean"))
    enc = jax_engine_charset("korean")
    for text in ("안녕하세요", "잘 가요", "ㅋㅋㅋ 123", "닭갈비 3인분", "ㄳ"):
        ids = enc.encode(text)
        assert cs.decode_ids(ids) == enc.decode_ids(ids)
    assert cs.decode_ids(enc.encode("안녕하세요")) == "안녕하세요"


def script_text(family):
    """Strings of a family's dict characters, ASCII digits and letters,
    spaces and punctuation."""
    chars = "".join(charset.get_charset(family).chars)
    return st.text(alphabet=chars + "0123456789 abcABCopxy:.,-", max_size=30)


@settings(max_examples=400, deadline=None)
@given(script_text("arabic"))
def test_visual_to_logical_matches_jax(text):
    assert visual_to_logical(text) == jax_visual_to_logical(text)


@settings(max_examples=400, deadline=None)
@given(st.sampled_from(["cyrillic", "el", "latin", "arabic"]), st.data())
def test_normalize_script_matches_jax(family, data):
    text = data.draw(script_text("cyrillic" if family in ("latin", "arabic") else family))
    assert normalize_script(text, family) == jax_normalize_script(text, family)


def test_decode_passes_on_known_lines():
    assert visual_to_logical("ةقلحلا 12") == jax_visual_to_logical("ةقلحلا 12") == "12 الحلقة"
    for text, family, want in (("пpивeт", "cyrillic", "привет"), ("hellо", "cyrillic", "hello"),
                               ("καλo", "el", "καλο")):
        assert normalize_script(text, family) == jax_normalize_script(text, family) == want


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_export_is_lossless_through_emulate(family):
    """The CRNN built from the orbax f32 params and the one built from the
    bf16-stored npz have bit-equal state dicts once both are emulated;
    BatchNorm arrays are stored as they were. The orbax head is restored
    into the flax CRNN's abstract variables (``jax.eval_shape`` of its init:
    the same tree ``init_or_load`` restores into, without compiling it)."""
    meta = load_rec_meta(family)
    n = int(meta["vocab_size"])
    assert n + 1 == CLASSES[family]
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.eval_shape(FlaxCRNN(vocab_size=n).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 48, 320, 3)))
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=cpu), abstract)
    variables = load_params(os.path.join(models_root(), f"rec_{family}_mobile"), like=like)
    orbax = {"/".join(k): np.asarray(v, np.float32) for k, v in flatten_dict(variables).items()}
    npz = load_rec_flat(family)
    assert sorted(npz) == sorted(orbax)
    assert npz["params/ctc_fc/kernel"].shape == (96, n + 1)
    models = []
    for flat in (orbax, npz):
        m = CRNNRecognizer(n)
        m.load_state_dict(from_jax_params(flat), strict=True)
        models.append(B16.emulate(m).state_dict())
    for k in models[0]:
        assert torch.equal(models[0][k], models[1][k]), k
    bn = [k for k in orbax if "BatchNorm_" in k]
    assert bn and all(np.array_equal(orbax[k], npz[k]) for k in bn)
    assert os.path.getsize(rec_head_paths(family)[0]) < 1_000_000


def test_crop_divides_as_xla_on_the_fault_10_box():
    """The second-pass crop box of the static watermark in the first frame
    of the ch fps chunk (the JAX engine's own refined box, bit for bit). Its
    ``48 / bh`` is one ulp off when computed as ``bh.reciprocal() * 48``
    (PyTorch's scalar / tensor), which moves column 94's x-tent weight
    across a bf16 rounding tie: 936 crop values of that chunk differed and
    the line's score read 0.8478 against the JAX engine's 0.9024. The crop
    must be bit-equal to the jitted JAX crop."""
    bands, recipe = load_fixture(recipe="recipe_ch_fps_short.json")
    frame = compose_frames(bands, recipe, n_frames=1)[0]
    box = np.array([0x44889A24, 0x41F87B13, 0x44991088, 0x42866AF7], np.uint32).view(np.float32)
    want = np.asarray(jax.jit(crop_axis_aligned_matmul_windowed, static_argnums=(2, 3))(
        jnp.asarray(frame), jnp.asarray(box), 48, 320))
    got = crop_boxes_windowed(torch.from_numpy(frame)[None], torch.from_numpy(box)[None, None],
                              48, 320)[0, 0].numpy()
    assert got.shape == want.shape == (48, 320, 3)
    np.testing.assert_array_equal(got, want)
    assert want[0, 94, 0] == np.float32(30.05859375)  # the tie rounded up, as XLA's

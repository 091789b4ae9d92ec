"""The last two CJK families, japan (C = 21,249) and chinese_cht (C = 21,060),
in the port against the JAX package, on the CPU: the copies of their dict
files, their bf16 head exports bit-exact through ``emulate``, the engine's
charset, and each family's keyframe clip (``recipe_scripts.json``: three
cues drawn by the JAX package's stroke composer, anti-aliased, in an area
narrowed to the cues) through ``SubtitleExtractor``, held against the JAX
CLI's committed SRT and the JAX extractor's lines of every keyframe sample
(``reference_scripts.json``). The heads' misreads are the reference (their
CER is 0.1418 and 0.1594 in ``GATES.json``): japan's SRT holds two cues,
chinese_cht's one, the rest scoring under the drop score. Engines OCR in
chunks of 2 frames, as the ch tests do (a chunk of 8 holds 435 MB of
logits)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from _torch_helpers import script_family_keyframe, two_threads  # noqa: F401
from vse_tpu.core import charset as jax_charset
from vse_tpu.core.registry import init_or_load, models_root
from vse_tpu.models.crnn import CRNNRecognizer as FlaxCRNN
from vse_tpu_torch.core import charset
from vse_tpu_torch.models import bf16 as B16
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.weights import from_jax_params, load_rec_flat, rec_head_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# classes with the blank, the JAX CLI's cues on the fixture clip
FAMILIES = {"japan": (21249, 2), "chinese_cht": (21060, 1)}


@pytest.mark.parametrize("family", FAMILIES)
def test_dict_copy_and_charset_match_jax(family):
    with open(os.path.join(ROOT, "vse_tpu", "assets", "dicts", f"{family}.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(charset.DICT_DIR, f"{family}.txt"), "rb") as f:
        assert f.read() == want
    got, ref = charset.get_charset(family), jax_charset.get_charset(family)
    assert got.chars == ref.chars
    assert got.without_space().vocab_size + 1 == FAMILIES[family][0]
    ids = range(0, FAMILIES[family][0] + 40)
    assert got.without_space().decode_ids(ids) == ref.without_space().decode_ids(ids)
    assert family in charset.PORTED_DICT_FAMILIES


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_export_is_lossless_through_emulate(family):
    """The CRNN built from the orbax f32 params and the one built from the
    bf16-stored npz have bit-equal state dicts once both are emulated;
    BatchNorm is stored as it was."""
    C = FAMILIES[family][0]
    flax_model = FlaxCRNN(vocab_size=C - 1)
    variables, loaded = init_or_load(flax_model, jnp.zeros((1, 48, 320, 3)),
                                     os.path.join(models_root(), f"rec_{family}_mobile"))
    assert loaded
    orbax = {"/".join(k): np.asarray(v, np.float32) for k, v in flatten_dict(variables).items()}
    npz = load_rec_flat(family)
    assert sorted(npz) == sorted(orbax)
    assert npz["params/ctc_fc/kernel"].shape == (96, C)
    models = []
    for flat in (orbax, npz):
        m = CRNNRecognizer(C - 1)
        m.load_state_dict(from_jax_params(flat), strict=True)
        models.append(B16.emulate(m).state_dict())
    for k in models[0]:
        assert torch.equal(models[0][k], models[1][k]), k
    bn = [k for k in orbax if "BatchNorm_" in k]
    assert bn and all(np.array_equal(orbax[k], npz[k]) for k in bn)
    assert os.path.getsize(rec_head_paths(family)[0]) < 4_000_000


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_resolves_the_family(family):
    engine = OcrEngine(family, device="cpu")
    assert engine.family == family
    assert engine.charset.vocab_size + 1 == FAMILIES[family][0]


@pytest.mark.parametrize("family", FAMILIES)
def test_keyframe_clip_matches_jax(family, tmp_path):
    ex = script_family_keyframe(family, tmp_path, n_cues=FAMILIES[family][1],
                                max_batch_size=2)
    assert ex.n_spans == 3 and ex.n_samples == 45

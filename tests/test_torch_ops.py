"""Parity of the port's image ops, DB postprocess and host modules with the
JAX package, on the same numpy inputs.

Tolerances: where the reference runs f32 (crops of float frames, DB
postprocess, ink rows) crops agree within 1e-3 gray levels, boxes within
1e-3 px, scores 1e-5, and integer outputs (valid, ink rows, spans, SRTs)
exactly. On uint8 frames the reference rounds through bf16 and the port
reproduces those roundings: its letterbox equals the jitted reference
exactly and lies within 1e-4 of a float64 numpy resample with the same
roundings; its crops of uint8 frames equal the reference's exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vse_tpu.core import charset as jax_charset
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.ops import db_postprocess as jax_db
from vse_tpu.ops import image as jax_image
from vse_tpu.ops.levenshtein import pure_ratio
from vse_tpu.pipeline import ocr_engine as jax_engine
from vse_tpu.post import dedup as jax_dedup
from vse_tpu.post.records import RawRecord as JaxRecord
from vse_tpu.post.srt import SrtFile as JaxSrt, SrtItem as JaxItem
from vse_tpu_torch.core import charset
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.ops import db_postprocess as db
from vse_tpu_torch.ops import image
from vse_tpu_torch.ops.levenshtein import ratio
from vse_tpu_torch.pipeline import ocr_engine
from vse_tpu_torch.post import dedup
from vse_tpu_torch.post.records import RawRecord
from vse_tpu_torch.post.srt import SrtFile, SrtItem



def test_letterbox_matches_float64_resample_and_jax():
    rng = np.random.default_rng(0)
    f = rng.integers(0, 256, (2, 45, 70, 3)).astype(np.uint8)
    got, inv = image.letterbox_matmul(torch.from_numpy(f), 64, 96)
    _, ref_inv = jax_image.letterbox_matmul(jnp.asarray(f), 64, 96)
    ref = jax.jit(lambda x: jax_image.letterbox_matmul(x, 64, 96)[0])(jnp.asarray(f))
    assert inv == tuple(ref_inv)
    nh, nw = round(45 * min(64 / 45, 96 / 70)), 96

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()

    wy = bf16(image.tent_matrix(nh, 45).numpy())
    wx = bf16(image.tent_matrix(nw, 70).numpy())
    mid = bf16(np.einsum("oh,bhwc->bowc", wy, f.astype(np.float64)))
    exact = np.einsum("bowc,pw->bopc", mid, wx)
    mean, std = np.array(image.IMAGENET_MEAN), np.array(image.IMAGENET_STD)
    exact = (exact / 255.0 - mean) / std
    got = got.numpy()
    np.testing.assert_allclose(got[:, :nh, :nw], exact, atol=1e-4)
    np.testing.assert_allclose(got[:, nh:], np.broadcast_to(-mean / std, got[:, nh:].shape), atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("h,window", [(40, 288), (60, 24)])
def test_crop_boxes_windowed_matches_jax(h, window):
    rng = np.random.default_rng(h)
    frames = rng.uniform(0, 255, (2, h, 90, 3)).astype(np.float32)
    boxes = np.array([
        [[5.3, 3.7, 80.2, 20.9], [10.0, 30.5, 40.0, h - 1.0], [0, 0, 0, 0]],
        [[1.0, 2.0, 89.0, 9.5], [50.5, 10.25, 52.0, 11.0], [3.0, h - 5.0, 70.0, h - 1.0]],
    ], np.float32)
    got = image.crop_boxes_windowed(torch.from_numpy(frames), torch.from_numpy(boxes), 12, 40, window).numpy()
    crop = jax.vmap(jax.vmap(
        lambda f, b: jax_image.crop_axis_aligned_matmul_windowed(f, b, 12, 40, window),
        in_axes=(None, 0)))
    ref = np.asarray(crop(jnp.asarray(frames), jnp.asarray(boxes)))
    assert got.shape == ref.shape == (2, 3, 12, 40, 3)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_crop_boxes_windowed_uint8_matches_jax():
    """uint8 frames take the bf16 path in both packages."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 300, 400, 3)).astype(np.uint8)
    boxes = np.array([
        [[5.3, 3.7, 380.2, 40.9], [10.0, 200.5, 140.0, 299.0]],
        [[1.0, 2.0, 399.0, 19.5], [50.5, 110.25, 352.0, 131.0]],
    ], np.float32)
    got = image.crop_boxes_windowed(torch.from_numpy(frames), torch.from_numpy(boxes), 48, 320).numpy()
    crop = jax.jit(jax.vmap(jax.vmap(
        lambda f, b: jax_image.crop_axis_aligned_matmul_windowed(f, b, 48, 320),
        in_axes=(None, 0))))
    ref = np.asarray(crop(jnp.asarray(frames), jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, ref)


def ink_crops(seed):
    """Float crops [N, 48, 64, 3]: one or two striped text bands on smooth
    backgrounds, plus a flat crop without ink."""
    rng = np.random.default_rng(seed)
    c = np.tile(np.linspace(20, 60, 64, dtype=np.float32)[None, :, None], (6, 48, 1, 3))
    c += rng.uniform(0, 1, c.shape).astype(np.float32)
    for i, (y0, y1) in enumerate([(14, 34), (10, 20), (20, 28), (2, 46), (18, 30)]):
        c[i, y0:y1, 4:60:3] = 240.0
    c[1, 36:44, 4:60:3] = 240.0  # a second line below a clean gap
    c[4, 23:25] = c[4, 23:25, :1]  # a 2-row dip inside the band (bridged)
    return c


def test_ink_rows_and_refine_match_jax():
    crops = ink_crops(0)
    y0, y1, ok = (a.numpy() for a in image.ink_rows(torch.from_numpy(crops)))
    r0, r1, rok = (np.asarray(a) for a in jax.vmap(jax_image.ink_rows)(jnp.asarray(crops)))
    np.testing.assert_array_equal(y0, r0)
    np.testing.assert_array_equal(y1, r1)
    np.testing.assert_array_equal(ok, rok)
    assert ok.any() and not ok[5]  # the flat crop has no ink band
    boxes = np.array([[10.0, 100.0, 200.0, 130.0]] * 6, np.float32).reshape(2, 3, 4)
    got = image.refine_boxes_ink(torch.from_numpy(crops.reshape(2, 3, 48, 64, 3)),
                                 torch.from_numpy(boxes), 0.07, 720).numpy()
    ref = np.asarray(jax_image.refine_boxes_ink(jnp.asarray(crops.reshape(2, 3, 48, 64, 3)),
                                                jnp.asarray(boxes), 0.07, 720))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_expand_boxes_y_matches_jax():
    b = np.random.default_rng(1).uniform(0, 100, (3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ocr_engine.expand_boxes_y(torch.from_numpy(b), 0.45, 90).numpy(),
        np.asarray(jax_engine._expand_boxes_y(jnp.asarray(b), 0.45, 90)), atol=1e-5)


def test_tight_crop_boxes_bit_equal_to_jitted_jax():
    """The crop stage's box maths as the reference's jitted program runs it
    (its multiply-adds fused, its divisions by constants turned into
    multiplies): expanded boxes and ink-refined boxes exactly equal, on
    uint8 frames with random boxes."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 720, 320, 3)).astype(np.uint8)
    for y in range(300, 700, 40):  # striped text rows for the refinement to find
        frames[:, y : y + 12, 40:280:3] = 250
    x0, y0 = rng.uniform(0, 150, (2, 64)), rng.uniform(300, 650, (2, 64))
    boxes = np.stack([x0, y0, x0 + rng.uniform(20, 160, (2, 64)),
                      np.minimum(y0 + rng.uniform(10, 60, (2, 64)), 719)], -1).astype(np.float32)
    cfg = JaxConfig(language="en")

    def reference(f, b):
        cb = jax_engine._expand_boxes_y(b, cfg.rec_crop_expand_y, 720)
        crops = jax.vmap(lambda fr, bb: jax.vmap(
            lambda one: jax_image.crop_axis_aligned_matmul_windowed(fr, one, 48, 320))(bb))(f, cb)
        return cb, jax_image.refine_boxes_ink(crops, cb, cfg.rec_crop_tight_margin, 720)

    want_cb, want = (np.asarray(a) for a in jax.jit(reference)(jnp.asarray(frames), jnp.asarray(boxes)))
    cb = ocr_engine.expand_boxes_y(torch.from_numpy(boxes), cfg.rec_crop_expand_y, 720)
    crops = image.crop_boxes_windowed(torch.from_numpy(frames), cb, 48, 320)
    got = image.refine_boxes_ink(crops, cb, cfg.rec_crop_tight_margin, 720)
    np.testing.assert_array_equal(cb.numpy(), want_cb)
    np.testing.assert_array_equal(got.numpy(), want)


def prob_maps():
    """[4, 64, 128] maps: random blobs; a U-shaped component (needs more
    than one sweep); equal-area components (lower index wins); and more
    components than K."""
    rng = np.random.default_rng(7)
    p = np.zeros((4, 64, 128), np.float32)
    for _ in range(6):
        y, x = rng.integers(0, 56), rng.integers(0, 110)
        p[0, y : y + rng.integers(4, 9), x : x + rng.integers(8, 30)] = rng.uniform(0.5, 1.0)
    p[1, 8:40, 8:16] = 0.9  # U: left arm
    p[1, 8:40, 48:56] = 0.8  # right arm
    p[1, 32:40, 8:56] = 0.7  # bottom
    p[1, 48:56, 80:120] = 0.65
    for k in range(4):  # four equal-area boxes
        p[2, 8 + 16 * (k % 2) : 16 + 16 * (k % 2), 16 + 48 * (k // 2) : 40 + 48 * (k // 2)] = 0.9
    for k in range(12):  # twelve components > K
        p[3, 4 + 20 * (k // 6) : 12 + 20 * (k // 6), 4 + 20 * (k % 6) : 12 + 20 * (k % 6) + k] = 0.7
    p += rng.uniform(0, 0.25, p.shape).astype(np.float32)
    return np.clip(p, 0, 1)


def test_db_postprocess_matches_jax():
    p = prob_maps()
    got = db.db_postprocess(torch.from_numpy(p), max_boxes=8, pool=8, num_sweeps=2)
    ref = jax_db.db_postprocess(jnp.asarray(p), max_boxes=8, pool=8, num_sweeps=2, with_angles=True)
    boxes, scores, valid, angles = (a.numpy() for a in got)
    r_boxes, r_scores, r_valid, r_angles = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(valid, r_valid)
    assert valid.sum() >= 10
    np.testing.assert_allclose(boxes, r_boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(scores, r_scores, atol=1e-5, rtol=0)
    np.testing.assert_allclose(angles, r_angles, atol=1e-4, rtol=0)


def test_bounded_labels_match_jax():
    """The bounded sweeps are the semantics, not an exact labelling: a
    spiral needs more than 2 sweeps, and both sides stop at the same
    partial labels."""
    b = np.zeros((24, 24), bool)
    b[2, 2:22] = b[2:22, 21] = b[21, 4:22] = b[6:22, 4] = b[6, 4:18] = b[6:18, 17] = True
    b[17, 8:18] = b[10:18, 8] = b[10, 8:14] = True
    for sweeps in (1, 2, 4):
        got = db.connected_component_labels(torch.from_numpy(b)[None], sweeps)[0].numpy()
        ref = np.asarray(jax_db.connected_component_labels(jnp.asarray(b), sweeps))
        np.testing.assert_array_equal(got, ref)


def test_y_round_and_sort_into_lines_match_jax():
    rng = np.random.default_rng(2)
    for y in range(-5, 60):
        assert ocr_engine.y_round(y) == jax_engine.y_round(y)
    for _ in range(20):
        coords = [tuple(int(v) for v in rng.integers(0, 200, 4)) for _ in range(6)]
        items = [(f"t{i}", 0.9) for i in range(6)]
        assert ocr_engine.sort_into_lines(coords, items) == jax_engine.sort_into_lines(coords, items)


def test_levenshtein_matches_jax():
    rng = np.random.default_rng(3)
    alphabet = list("abcde ")
    for _ in range(200):
        a = "".join(rng.choice(alphabet, rng.integers(0, 9)))
        b = "".join(rng.choice(alphabet, rng.integers(0, 9)))
        assert ratio(a, b) == pure_ratio(a, b)


def test_dedup_and_srt_match_jax():
    rng = np.random.default_rng(4)
    texts = ["hello there", "hello there!", "helo there", "another line", "", "x y"]
    recs = [(int(f), (1, 2, 3, 4), str(rng.choice(texts)))
            for f in sorted(rng.choice(np.arange(1, 400), 40, replace=False))]
    for thr, single in ((80, True), (80, False), (50, True)):
        got = dedup.remove_duplicate_subtitles([RawRecord(*r) for r in recs], thr, single)
        ref = jax_dedup.remove_duplicate_subtitles([JaxRecord(*r) for r in recs], thr, single)
        assert got == ref
    tl = [(i + 1, 1000 * i, 1000 * i + 900) for i in range(0, 20, 2)]
    spans = [(int(s / 25.0), int(s / 25.0) + 10, "cue") for _, s, _ in tl[::2]]
    for keep in (True, False):
        got = dedup.generate_srt_from_timeline(
            SrtFile([SrtItem(i, s, e, "") for i, s, e in tl]), spans, lambda ms: int(ms / 25.0), keep)
        ref = jax_dedup.generate_srt_from_timeline(
            JaxSrt([JaxItem(i, s, e, "") for i, s, e in tl]), spans, lambda ms: int(ms / 25.0), keep)
        assert got.dumps() == ref.dumps()


def test_en_charset_and_config_match_jax():
    en = charset.get_charset("en")
    ref = jax_charset.get_charset("en")
    for got, want in ((en, ref), (en.folded(), ref.folded()),
                      (en.folded().without_space(), ref.folded().without_space())):
        assert got.chars == want.chars
        assert got.decode_ids(range(100)) == want.decode_ids(range(100))
    assert en.folded().without_space().vocab_size == 68
    with pytest.raises(NotImplementedError):  # a code of no family
        charset.get_charset("xx")
    ours = VseConfig()
    for f in dataclasses.fields(VseConfig):  # every field the port keeps
        assert getattr(ours, f.name) == getattr(JaxConfig(), f.name), f.name
    with pytest.raises(ValueError):
        VseConfig(drop_score=101)

"""The port's optimizer and losses (``vse_tpu_torch/train/optim.py``,
``losses.py``) against optax and ``vse_tpu/train/losses.py``.

Tolerances: parameters after 6 steps within 1e-6 of optax's; schedule values
rtol 1e-6; loss values rtol 1e-5; gradients within 1e-5 of the largest for
the DB terms, and for CTC within (1e-6 x the loss) of the largest: both f32
implementations' alpha-beta sums lose precision in proportion to the
loss (at ~400 a sequence each sits 3-4e-5 from the f64 gradient, whose
largest value is 0.25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vse_tpu.train import losses as jl
from vse_tpu_torch.train import losses as tl
from vse_tpu_torch.train import optim
from vse_tpu_torch.train.pretrain import det_optimizer, rec_optimizer

TREE = {"a": (3, 4), "b": (5,), "c": (2, 3, 3)}


def _grads(rng):
    return [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in TREE.items()}
            for scale in (0.1, 3.0, 0.1, 3.0, 0.5, 8.0)]


@pytest.mark.parametrize("chain", ["rec", "det"])
def test_optimizer_follows_optax_for_six_steps(chain):
    """train_rec's chain (clip at 1, adam) and train_det's adamw, with a
    warmup of 2 and 8 decay steps, on a small tree: steps alternate under
    and over the clip norm."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in TREE.items()}
    sched = optax.warmup_cosine_decay_schedule(0, 1e-2, 2, 8)
    tx = (optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched)) if chain == "rec"
          else optax.adamw(sched))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.tensor(params[k]) for k in TREE]
    opt = optim.Optimizer(rec_optimizer(1e-2, 2, 8) if chain == "rec"
                          else optim.adamw(optim.warmup_cosine_decay_schedule(0, 1e-2, 2, 8)), tp)
    for g in _grads(rng):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(g[k]) for k in TREE])
    for k, t in zip(TREE, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    # the moments too: optax's tree, flattened, against the port's lists
    mu = state[1][0].mu if chain == "rec" else state[0].mu
    moments = opt.state[1][0] if chain == "rec" else opt.state[0]
    for k, m in zip(TREE, moments["mu"]):
        np.testing.assert_allclose(m.numpy(), np.asarray(mu[k]), rtol=1e-6, atol=1e-9)
    assert int(moments["count"]) == 6


def test_det_optimizer_is_optax_adamw_with_the_default_decay():
    """det_optimizer(lr, steps) == optax.adamw(warmup_cosine(0, lr, 100,
    steps)), weight decay 1e-4 on every parameter, checked at counts past
    the warmup (a state restored at step 120)."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((4, 4)).astype(np.float32)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0, 5e-4, 100, 300))
    st = tx.init(jnp.asarray(p))
    st = (st[0]._replace(count=jnp.int32(120)), st[1], st[2]._replace(count=jnp.int32(120)))
    tp = torch.tensor(p)
    opt = optim.Optimizer(det_optimizer(5e-4, 300), [tp])
    opt.state[0]["count"].fill_(120)
    opt.state[2]["count"].fill_(120)
    jp = jnp.asarray(p)
    for _ in range(3):
        g = rng.standard_normal((4, 4)).astype(np.float32)
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
        opt.step([torch.tensor(g)])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)


@pytest.mark.parametrize("warmup,decay", [(100, 300), (100, 101), (200, 40000), (2, 8)])
def test_schedule_matches_optax(warmup, decay):
    """The lr at the count before each update: 0 at count 0, the peak at
    the end of the warmup, 0 from ``decay`` on."""
    counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, (warmup + decay) // 2,
                     decay - 1, decay, decay + 50})
    want = optax.warmup_cosine_decay_schedule(0, 1e-3, warmup, decay)
    got = optim.warmup_cosine_decay_schedule(0, 1e-3, warmup, decay)
    for c in counts:
        assert float(got(torch.tensor(c, dtype=torch.int32))) == pytest.approx(
            float(want(c)), rel=1e-6, abs=1e-12)
    assert float(got(torch.tensor(0, dtype=torch.int32))) == 0.0


@pytest.mark.parametrize("decay", [100, 4, 1])
def test_schedule_refuses_what_optax_refuses(decay):
    """``decay_steps`` counts the warmup: train_rec and train_det need more
    than 100 steps, in both packages."""
    with pytest.raises(ValueError, match="positive decay_steps"):
        optax.warmup_cosine_decay_schedule(0, 1e-3, 100, decay)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.warmup_cosine_decay_schedule(0, 1e-3, 100, decay)


def test_clip_scales_as_optax_not_as_clip_grad_norm():
    """Under the norm, gradients pass unchanged (clip_grad_norm_ would scale
    by max_norm / (norm + 1e-6)); over it, they come out at norm 1."""
    clip = optim.clip_by_global_norm(1.0)
    small = [torch.tensor([0.3, 0.4])]
    assert torch.equal(clip.update(small, (), None)[0][0], small[0])
    big = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    out, _ = clip.update(big, (), None)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(b.numpy()) for b in big], optax.EmptyState())
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6)
    assert float(torch.sqrt(sum((o * o).sum() for o in out))) == pytest.approx(1.0, rel=1e-6)


def test_state_round_trips_through_flat_arrays():
    params = [torch.randn(3, 4), torch.randn(5)]
    opt = optim.Optimizer(rec_optimizer(1e-3, 100, 300), params)
    opt.step([torch.randn(3, 4), torch.randn(5)])
    flat = optim.state_to_flat(opt.state)
    assert sorted(flat) == ["1/0/count", "1/0/mu/0", "1/0/mu/1", "1/0/nu/0", "1/0/nu/1",
                            "1/1/count"]
    fresh = optim.Optimizer(rec_optimizer(1e-3, 100, 300), [p.clone() for p in params])
    back = optim.state_from_flat(flat, fresh.state)
    assert optim.state_to_flat(back).keys() == flat.keys()
    for k, v in optim.state_to_flat(back).items():
        assert np.array_equal(v, flat[k]) and v.dtype == flat[k].dtype
    with pytest.raises(ValueError):
        optim.state_from_flat({**flat, "1/0/mu/1": np.zeros(4, np.float32)}, fresh.state)


def _db_inputs(seed, shape=(2, 24, 40)):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0.001, 0.999, shape).astype(np.float32)
    thresh = rng.uniform(0.2, 0.8, shape).astype(np.float32)
    binary = rng.uniform(0, 1, shape).astype(np.float32)
    gt = (rng.uniform(size=shape) < 0.15).astype(np.float32)
    gt_mask = (rng.uniform(size=shape) < 0.9).astype(np.float32)
    gt_thresh = rng.uniform(0.3, 0.7, shape).astype(np.float32)
    gt_thresh_mask = (rng.uniform(size=shape) < 0.3).astype(np.float32)
    return (prob, thresh, binary), (gt, gt_mask, gt_thresh, gt_thresh_mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("term", ["balanced_bce", "dice_loss", "masked_l1", "db_loss"])
def test_db_losses_and_gradients_match_jax(seed, term):
    (prob, thresh, binary), (gt, gm, gt_t, gtm) = _db_inputs(seed)
    args = {"balanced_bce": (prob, gt, gm), "dice_loss": (binary, gt, gm),
            "masked_l1": (thresh, gt_t, gtm),
            "db_loss": (prob, thresh, binary, gt, gm, gt_t, gtm)}[term]
    n_in = 3 if term == "db_loss" else 1

    def first(v):
        return v[0] if isinstance(v, tuple) else v

    jf = lambda *xs: first(getattr(jl, term)(*xs, *args[n_in:]))  # noqa: E731
    jv, jg = jax.value_and_grad(jf, argnums=tuple(range(n_in)))(*args[:n_in])
    xs = [torch.tensor(a, requires_grad=True) for a in args[:n_in]]
    tv = first(getattr(tl, term)(*xs, *(torch.tensor(a) for a in args[n_in:])))
    tg = torch.autograd.grad(tv, xs)
    assert float(tv) == pytest.approx(float(jv), rel=1e-5)
    gmax = max(float(jnp.abs(g).max()) for g in jg)
    for a, b in zip(jg, tg):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5 * gmax


def test_db_loss_metrics_are_the_three_terms():
    (p, t, b), gts = _db_inputs(7)
    total, m = tl.db_loss(*(torch.tensor(a) for a in (p, t, b, *gts)))
    _, jm = jl.db_loss(p, t, b, *gts)
    assert set(m) == {"shrink_bce", "binary_dice", "thresh_l1"}
    for k in m:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    assert float(total) == pytest.approx(
        float(m["shrink_bce"] + 5 * m["binary_dice"] + 10 * m["thresh_l1"]), rel=1e-6)


@pytest.mark.parametrize("scale", [0.5, 2.0, 6.0])
def test_ctc_loss_and_gradient_match_optax(scale):
    """[4, 80, 69] logits, labels with repeats (3 3 3 4 4 needs blanks
    between the runs), lengths 1-24: optax's per-sequence loss, mean over
    the batch (``F.ctc_loss``'s default reduction would divide by each
    label's length)."""
    rng = np.random.default_rng(int(scale * 10))
    logits = (rng.standard_normal((4, 80, 69)) * scale).astype(np.float32)
    labels = np.zeros((4, 24), np.int32)
    lengths = np.array([5, 24, 1, 12], np.int32)
    for b in range(4):
        labels[b, : lengths[b]] = rng.integers(1, 69, lengths[b])
    labels[0, :5] = [3, 3, 3, 4, 4]
    jv, jg = jax.value_and_grad(lambda x: jl.ctc_rec_loss(x, labels, lengths))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tv = tl.ctc_rec_loss(x, torch.tensor(labels), torch.tensor(lengths))
    (tg,) = torch.autograd.grad(tv, x)
    assert float(tv) == pytest.approx(float(jv), rel=1e-5)
    err = np.abs(np.asarray(jg) - tg.numpy()).max() / float(jnp.abs(jg).max())
    print(f"loss {float(jv):.1f}, gradient error {err:.2e} of the largest")
    assert err <= 1e-6 * float(jv)
    mean_per_len = torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1).transpose(0, 1), torch.tensor(labels).long(),
        torch.full((4,), 80), torch.tensor(lengths).long())
    assert float(mean_per_len) != pytest.approx(float(tv), rel=1e-3)


@pytest.mark.parametrize("max_len", [24, 36, 56])
def test_every_training_label_fits_the_ctc_time_axis(max_len):
    """CTC needs T >= L + (adjacent repeats). The rec configs train_rec
    builds have T = 320 / 4 = 80 steps: 24 labels (2L - 1 = 47) and 36 (71)
    fit whatever they repeat; the jamo heads' 56 labels fit because a
    positional-jamo sequence has no adjacent repeat inside Hangul (initial,
    medial and final classes differ), checked on every syllable pair of the
    korean alphabet's first 200 syllables."""
    if max_len < 56:
        assert 2 * max_len - 1 <= 80
        return
    from vse_tpu_torch.core.charset import get_charset, to_jamo

    cs = to_jamo(get_charset("korean"))
    syl = [c for c in get_charset("korean").chars if 0xAC00 <= ord(c) <= 0xD7A3][:200]
    for a in syl:
        ids = cs.encode(a + a)
        assert all(x != y for x, y in zip(ids, ids[1:]))
    assert max_len + 24 <= 80  # up to 24 repeats (digits, ascii) still fit

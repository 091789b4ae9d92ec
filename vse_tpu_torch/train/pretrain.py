"""Synthetic pretraining on the card (the port of
``vse_tpu/train/pretrain.py``): CRNN recognizers on rendered text lines, the
DB detector on rendered subtitle frames.

  python -m vse_tpu_torch.train.pretrain rec    --language en --steps N --batch 64 --pregen P
  python -m vse_tpu_torch.train.pretrain det    --steps N --batch 16 --pregen P
  python -m vse_tpu_torch.train.pretrain render --language en --pregen P --batch 64 [--det]

The flags are the JAX package's, plus ``--device cuda|cpu`` (default
``cuda``; without CUDA only ``--device cpu`` runs). Heads land where the
port's engine reads them: ``<models_root()>/rec_<family>_<variant>.npz`` and
``det_<variant>.npz`` with their ``.vse_meta.json`` (``$VSE_MODELS``, else
``checkpoints_torch/``, whose committed heads a run would otherwise resume
from or overwrite); the optimizer state goes to ``core/registry.py::
opt_path``. ``--pregen P`` renders P batches (or, for the det, P frames)
once into ``$VSE_DATA_DIR`` (else the temp dir) under the JAX package's file
names, or loads them from there: a machine without PIL and the DejaVu fonts
trains from such a pre-rendered file only.

``rec_step`` and ``det_step`` are the JAX package's nested ``step_core`` /
``step_fn``: one forward in training mode (f32, batch statistics), the loss,
its gradient and one optimizer update. Both models train in f32; the bf16
emulation (``models/bf16.py``) is for inference.
"""

from __future__ import annotations

import argparse
import math
import os
import queue
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from vse_tpu_torch.core.charset import JamoCharset, get_charset, script_family
from vse_tpu_torch.core.registry import find_opt_sidecar, models_root, opt_path
from vse_tpu_torch.device import resolve_device
from vse_tpu_torch.kernels.ctc_decode import ctc_greedy_decode
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.db_detector import DBDetector
from vse_tpu_torch.ops.ctc import decode_batch_to_texts
from vse_tpu_torch.train import optim
from vse_tpu_torch.train.device_loop import DET_GT_KEYS, DET_MEAN, DET_STD
from vse_tpu_torch.train.losses import ctc_rec_loss, db_loss
from vse_tpu_torch.train.synth import STROKE_FAMILIES, SynthConfig, TextRenderer, rec_render_config
from vse_tpu_torch.weights import (
    from_jax_det, from_jax_params, load_flat, load_meta, save_flat, to_jax_det, to_jax_params,
)


def _prefetch(make_batch, depth=8, workers=6):
    """Parallel host-side batch generation (PIL rendering is the
    bottleneck; one renderer thread starves the card)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker(wid):
        while not stop.is_set():
            batch = make_batch(wid)
            while not stop.is_set():
                try:
                    q.put(batch, timeout=1)
                    break
                except queue.Full:
                    continue

    for wid in range(workers):
        threading.Thread(target=worker, args=(wid,), daemon=True).start()
    return q, stop


def _rec_train_charset(language: str, use_space: bool, fold_case: bool):
    charset = get_charset(language)
    if fold_case and charset.name in ("en", "latin", "cyrillic", "el"):
        charset = charset.folded()
    if not use_space:
        charset = charset.without_space()
    if charset.name == "korean":
        # positional-jamo CTC classes (2,350 syllables -> 161 classes)
        from vse_tpu_torch.core.charset import to_jamo

        charset = to_jamo(charset)
    if charset.name == "arabic":
        # DejaVu's pixel-identical homoglyphs folded onto one class each
        from vse_tpu_torch.core.arabic import HOMOGLYPHS

        charset = charset.aliased(HOMOGLYPHS)
    return charset


def rec_train_config(charset) -> SynthConfig:
    """The rec render profile with the label length the charset needs:
    56 for jamo (2-3 labels a syllable), 36 for the stroke scripts
    (combining marks add labels without advancing the pen), else 24."""
    cfg = rec_render_config()
    if isinstance(charset, JamoCharset):
        cfg.max_label_len = 56
    elif charset.name in STROKE_FAMILIES:
        cfg.max_label_len = 36
    return cfg


def data_dir() -> str:
    """Where pre-rendered datasets are cached: ``$VSE_DATA_DIR``, else the
    temp dir."""
    return os.environ.get("VSE_DATA_DIR") or tempfile.gettempdir()


def rec_dataset_path(language: str, pregen: int, batch: int) -> str:
    """The JAX package's cache name (``g6``: the generation of the
    renderer's output; a cached file keeps the old one)."""
    cfg = rec_render_config()
    return os.path.join(
        data_dir(), f"vse_rec_ds_{language}_{pregen}x{batch}"
        f"_w{int(cfg.words_only)}s{cfg.fixed_stroke}g6.npz")


def det_dataset_path(pregen: int, det_h: int = 256, det_w: int = 448) -> str:
    return os.path.join(data_dir(), f"vse_det_ds_{pregen}_{det_h}x{det_w}.npz")


def render_rec_dataset(language: str, n: int, seed: int = 0, use_space: bool = False,
                       fold_case: bool = True):
    """``n`` rec crops in curriculum order (clean -> hard: difficulty rises
    to 1 by the middle) and their texts."""
    charset = _rec_train_charset(language, use_space, fold_case)
    r = TextRenderer(charset, rec_render_config(), seed=seed)
    imgs, texts = [], []
    for bi in range(n):
        r.cfg.difficulty = min(1.0, 2.0 * bi / max(1, n))
        img, text = r.render_line()
        imgs.append(img)
        texts.append(text)
    return np.stack(imgs), texts


def load_or_render_rec_dataset(language: str, pregen: int, batch: int, seed: int = 0,
                               use_space: bool = False, fold_case: bool = True):
    """The cached rec dataset (u8 crops [N, 48, 320, 3], texts), rendered
    on the host on first use."""
    ds_path = rec_dataset_path(language, pregen, batch)
    if os.path.exists(ds_path):
        print(f"loading cached dataset {ds_path}")
        with np.load(ds_path, allow_pickle=True) as z:
            raw_imgs, all_texts = z["images"], z["texts"]
    else:
        print(f"pre-rendering {pregen} batches x {batch}...", flush=True)
        t_gen = time.time()
        raw_imgs, all_texts = render_rec_dataset(language, pregen * batch, seed,
                                                 use_space, fold_case)
        np.savez_compressed(ds_path, images=raw_imgs, texts=np.array(all_texts, object))
        print(f"dataset ready in {time.time() - t_gen:.0f}s -> {ds_path}")
    return raw_imgs, [str(t) for t in all_texts]


def render_det_dataset(n: int, det_h: int = 256, det_w: int = 448, seed: int = 0) -> dict:
    """``n`` det frames and their DB label maps (f16)."""
    r = TextRenderer(get_charset("en"), SynthConfig(det_h=det_h, det_w=det_w), seed=seed)
    frames, maps = [], {k: [] for k in DET_GT_KEYS}
    for _ in range(n):
        img, boxes = r.render_frame()
        lab = r.det_labels(boxes)
        frames.append(img)
        for k in DET_GT_KEYS:
            maps[k].append(lab[k])
    ds = {"images": np.stack(frames)}
    ds.update({k: np.stack(v).astype(np.float16) for k, v in maps.items()})
    return ds


def load_or_render_det_dataset(pregen: int, det_h: int = 256, det_w: int = 448,
                               seed: int = 0) -> dict:
    """The cached det dataset (frames + DB shrink / threshold maps)."""
    ds_path = det_dataset_path(pregen, det_h, det_w)
    if os.path.exists(ds_path):
        print(f"loading cached det dataset {ds_path}")
        with np.load(ds_path) as z:
            return {k: z[k] for k in z.files}
    print(f"pre-rendering {pregen} det frames...", flush=True)
    t_g = time.time()
    ds = render_det_dataset(pregen, det_h, det_w, seed)
    np.savez_compressed(ds_path, **ds)
    print(f"det dataset ready in {time.time() - t_g:.0f}s -> {ds_path}")
    return ds


def encode_labels(charset, texts: Sequence[str], max_len: int):
    """Texts -> ([N, max_len] int32 ids padded with 0, [N] lengths); an
    empty encoding becomes the one label 1, as in the JAX package."""
    labels = np.zeros((len(texts), max_len), np.int32)
    lengths = np.zeros((len(texts),), np.int32)
    for k, t in enumerate(texts):
        ids = charset.encode(t)[:max_len] or [1]
        labels[k, : len(ids)] = ids
        lengths[k] = len(ids)
    return labels, lengths


def flax_init(model: nn.Module, seed: int) -> nn.Module:
    """Initialize ``model`` as flax initializes its counterpart: conv,
    transposed-conv and dense kernels and the LSTM input kernels lecun
    normal (a normal truncated at 2 sigma, std sqrt(1 / fan_in) / .8796),
    the LSTM recurrent kernels orthogonal a gate, biases 0, BatchNorm 1 / 0.
    The values differ from JAX's (another generator); the distribution is
    the one the JAX recipe was tuned on."""
    gen = torch.Generator().manual_seed(seed)

    def lecun_(w: torch.Tensor, fan_in: int) -> None:
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        v = torch.empty(w.shape)
        nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.copy_(v * std)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                lecun_(m.weight, m.weight[0].numel())
            elif isinstance(m, nn.ConvTranspose2d):
                lecun_(m.weight, m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3])
            elif isinstance(m, nn.Linear):
                lecun_(m.weight, m.weight.shape[1])
            elif isinstance(m, nn.LSTM):
                for name, p in m.named_parameters():
                    if name.startswith("weight_ih"):
                        lecun_(p, p.shape[1])
                    elif name.startswith("weight_hh"):
                        for g in p.chunk(4, dim=0):
                            v = torch.empty(g.shape)
                            nn.init.orthogonal_(v, generator=gen)
                            g.copy_(v)
                    else:
                        p.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
                continue
            else:
                continue
            if getattr(m, "bias", None) is not None and not isinstance(m, nn.LSTM):
                m.bias.zero_()
    return model


def trainable(model: nn.Module) -> List[torch.Tensor]:
    """The parameters an optimizer moves (the flax module's params; the
    LSTMs' frozen ``bias_ih`` is left out)."""
    return [p for p in model.parameters() if p.requires_grad]


def rec_optimizer(lr: float, warmup: int, sched_steps: int) -> optim.Transform:
    """``train_rec``'s chain: global-norm clipping at 1, then Adam on the
    warmup-cosine schedule."""
    return optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adam(optim.warmup_cosine_decay_schedule(0, lr, warmup, sched_steps)))


def det_optimizer(lr: float, steps: int) -> optim.Transform:
    """``train_det``'s ``optax.adamw`` (weight decay 1e-4 on every
    parameter), 100 warmup steps."""
    return optim.adamw(optim.warmup_cosine_decay_schedule(0, lr, 100, steps))


def rec_step(model: nn.Module, opt: optim.Optimizer, images: torch.Tensor,
             labels: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One training step of the CRNN (``train_rec``'s ``step_core``); the
    running statistics move in the forward. Returns the loss."""
    model.train()
    loss = ctc_rec_loss(model(images), labels, lengths)
    opt.step(torch.autograd.grad(loss, opt.params))
    return loss.detach()


def det_step(model: nn.Module, opt: optim.Optimizer, batch: Dict[str, torch.Tensor]):
    """One training step of the DB detector (``train_det``'s ``step_fn``).
    Returns (loss, metrics)."""
    model.train()
    prob, thresh, binary = model(batch["det_images"])
    loss, metrics = db_loss(prob, thresh, binary, *(batch[k] for k in DET_GT_KEYS))
    opt.step(torch.autograd.grad(loss, opt.params))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


def save_optimizer(opt: optim.Optimizer, base: str, step: int) -> None:
    save_flat(optim.state_to_flat(opt.state), opt_path(base), {"step": step})


def restore_optimizer(opt: optim.Optimizer, base: str, step: int) -> bool:
    """Load the sidecar of the head at ``base`` when it was saved at
    ``step``."""
    side = find_opt_sidecar(base)
    meta = load_meta(side) if side else None
    if not meta or int(meta.get("step", -1)) != step:
        return False
    opt.state = optim.state_from_flat(load_flat(side + ".npz"), opt.state)
    return True


def predict_texts(model: nn.Module, images: torch.Tensor, charset) -> List[str]:
    """Greedy reads of normalized crops with the running statistics (K1 on
    the card)."""
    model.eval()
    with torch.no_grad():
        ids, mask, _ = ctc_greedy_decode(model(images).contiguous())
    model.train()
    return decode_batch_to_texts(ids.cpu().numpy(), mask.cpu().numpy(), charset)


def train_rec(language: str, steps: int, batch: int, lr: float, seed: int,
              variant: str = "mobile", log_every: int = 50, pregen: int = 0,
              use_space: bool = False, fold_case: bool = True, device_data: bool = True,
              fresh: bool = False, fresh_opt: bool = False, hidden: int = 0,
              cnn_scale: float = 0.0, device="cuda") -> str:
    """Train a rec head; returns its base path (``<base>.npz``).

    ``pregen`` > 0: render (or load) that many batches up front, in
    curriculum order, and train from them on the device
    (``device_loop.run_rec_device_loop``, 200 steps a host sync; a
    checkpoint every 1000 steps and at the end);
    ``device_data=False`` feeds them from a host thread with the numpy /
    OpenCV augmentation instead. ``pregen`` 0 renders live in host threads.
    A head at the base path with the same classes and widths is resumed
    (with its optimizer sidecar when that holds the same step) unless
    ``fresh``; ``fresh_opt`` keeps its weights but starts a new schedule
    over the remaining steps. ``use_space=False`` drops the space class."""
    dev = resolve_device(device)
    charset = _rec_train_charset(language, use_space, fold_case)
    cfg = rec_train_config(charset)
    is_jamo = isinstance(charset, JamoCharset)
    model = flax_init(CRNNRecognizer(charset.vocab_size, hidden, cnn_scale, variant), seed)
    model.to(dev).train()
    base = os.path.join(models_root(), f"rec_{script_family(language)}_{variant}")
    # the resume point decides the schedule's length under fresh_opt
    prior_step = 0
    if not fresh and os.path.exists(base + ".npz"):
        pm = load_meta(base)
        if (pm and pm.get("vocab_size") == charset.vocab_size
                and int(pm.get("hidden", 0)) == hidden
                and float(pm.get("cnn_scale", 0.0)) == cnn_scale):
            prior_step = int(pm.get("step", 0))
    sched_steps = max(1, steps - prior_step) if fresh_opt else steps
    warmup = 200 if (fresh_opt and prior_step) else 100
    opt = optim.Optimizer(rec_optimizer(lr, warmup, sched_steps), trainable(model))
    meta = {
        "language": language,
        "use_space_char": charset.use_space_char,
        "fold_case": charset.fold_case,
        "vocab_size": charset.vocab_size,
        "variant": variant,
        "hidden": hidden,
        "cnn_scale": cnn_scale,
        "jamo": is_jamo,
        "homoglyph_fold": bool(charset.aliases),
        # the crop geometry this head was trained for (the engine warns on
        # a mismatch): the ink-tight re-crop
        "geometry": "tight1",
    }

    def checkpoint(step):
        # the sidecar first: a kill between the two saves leaves a head
        # whose step is older than the sidecar's, which resume then ignores
        save_optimizer(opt, base, step)
        save_flat(to_jax_params(model.state_dict()), base, {**meta, "step": step})

    start_step = 0
    if prior_step > 0:
        try:
            model.load_state_dict(from_jax_params(load_flat(base + ".npz")))
            start_step = prior_step
            print(f"resuming {base} from step {start_step}"
                   + (" (fresh optimizer)" if fresh_opt else ""))
            if not fresh_opt and restore_optimizer(opt, base, start_step):
                print("restored optimizer state (adam moments + schedule)")
        except (KeyError, ValueError, RuntimeError) as e:
            print(f"resume failed ({e}); training from scratch")
    if start_step >= steps:
        # never rewrite a finished head's meta (a no-op run would reset it)
        print(f"{base} already at step {start_step} >= {steps}; nothing to do")
        return base

    t0 = time.time()

    def log_line(step, loss, preds, gts, what):
        exact = sum(p == t for p, t in zip(preds, gts))
        print(f"[rec {language}] step {step} loss {loss:.4f} {what} {exact}/4 "
               f"({time.time() - t0:.0f}s) pred={preds[0]!r} gt={gts[0]!r}")

    if pregen > 0:
        raw_imgs, all_texts = load_or_render_rec_dataset(
            language, pregen, batch, seed, use_space=use_space, fold_case=fold_case)
    if pregen > 0 and device_data:
        from vse_tpu_torch.train.device_loop import run_rec_device_loop

        labels_all, lengths_all = encode_labels(charset, all_texts, cfg.max_label_len)
        probe = torch.from_numpy(
            (raw_imgs[:4].astype(np.float32) / 255.0 - 0.5) / 0.5).to(dev)
        probe_texts = all_texts[:4]

        def log_cb(step, loss):
            log_line(step, loss, predict_texts(model, probe, charset), probe_texts,
                     "probe-exact")

        def checkpoint_cb(step):
            checkpoint(step)
            print(f"[rec {language}] checkpoint @ {step}")

        run_rec_device_loop(
            raw_imgs=raw_imgs, labels=labels_all, lengths=lengths_all,
            step_core=lambda x, lb, ln: rec_step(model, opt, x, lb, ln),
            steps=steps, start_step=start_step, batch=batch, seed=seed, device=dev,
            checkpoint_cb=checkpoint_cb, log_cb=log_cb)
        checkpoint(steps)
        print(f"saved {base}")
        return base

    aug_rng = np.random.default_rng(seed + 13)
    difficulty = {"value": 0.0}
    renderers: Dict[int, TextRenderer] = {}

    def make_batch(wid):
        # one renderer (and generator) per worker thread
        if wid not in renderers:
            renderers[wid] = TextRenderer(charset, cfg, seed=seed * 100 + wid)
        r = renderers[wid]
        r.cfg.difficulty = difficulty["value"]
        b = r.rec_batch(batch)
        imgs = ((b["rec_images"].astype(np.float32) / 255.0) - 0.5) / 0.5
        return imgs, b["labels"], b["label_lengths"], b["texts"]

    def cache_batch(i: int):
        # curriculum: the clean prefix first, everything by 40% of the run;
        # random indices within the window
        total = len(all_texts)
        frac = min(1.0, i / max(1, steps * 0.4))
        window = max(batch * 8, int(total * frac))
        idx = aug_rng.integers(0, min(window, total), size=batch)
        imgs = (host_augment(raw_imgs[idx], aug_rng) / 255.0 - 0.5) / 0.5
        texts = [all_texts[k] for k in idx]
        labels, lengths = encode_labels(charset, texts, cfg.max_label_len)
        return imgs.astype(np.float32), labels, lengths, texts

    q = stop = None
    cache_q: "queue.Queue" = queue.Queue(maxsize=4)
    cache_stop = threading.Event()
    if pregen > 0:
        def cache_feeder():
            for i in range(start_step, steps):
                b = cache_batch(i)
                while not cache_stop.is_set():
                    try:
                        cache_q.put(b, timeout=1)
                        break
                    except queue.Full:
                        continue
                if cache_stop.is_set():
                    return

        threading.Thread(target=cache_feeder, daemon=True).start()
    else:
        q, stop = _prefetch(make_batch)
    try:
        for i in range(start_step, steps):
            if i > 0 and i % 1000 == 0:
                checkpoint(i)
            if pregen > 0:
                imgs, labels, lengths, texts = cache_q.get()
            else:
                difficulty["value"] = min(1.0, 2.0 * i / max(1, steps))
                imgs, labels, lengths, texts = q.get()
            x = torch.from_numpy(imgs).to(dev)
            loss = rec_step(model, opt, x, torch.from_numpy(labels).to(dev),
                            torch.from_numpy(lengths).to(dev))
            if i % log_every == 0 or i == steps - 1:
                log_line(i, float(loss), predict_texts(model, x[:4], charset), texts[:4],
                         "sample-exact")
    finally:
        cache_stop.set()
        if stop is not None:
            stop.set()
    checkpoint(steps)
    print(f"saved {base}")
    return base


def host_augment(imgs_u8: np.ndarray, aug_rng: np.random.Generator) -> np.ndarray:
    """The host path's photometric jitter, noise, shift and (p .5 each)
    resample chain and crop-expansion geometry over cached renders, in
    numpy and OpenCV (imported here, where it is needed)."""
    x = imgs_u8.astype(np.float32)
    n = x.shape[0]
    gain = aug_rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
    bias = aug_rng.uniform(-30, 30, size=(n, 1, 1, 1)).astype(np.float32)
    chan = aug_rng.uniform(0.9, 1.1, size=(n, 1, 1, 3)).astype(np.float32)
    x = (x - 127.5) * gain + 127.5 + bias
    x = x * chan
    x += aug_rng.normal(0, aug_rng.uniform(0, 8), size=x.shape)
    shift = int(aug_rng.integers(0, 9))
    if shift:
        x = np.roll(x, shift, axis=2)
        x[:, :, :shift] = x[:, :, shift : shift + 1]
    x = np.clip(x, 0, 255)
    if aug_rng.random() < 0.5:
        import cv2

        h, w = x.shape[1], x.shape[2]
        sy = float(aug_rng.uniform(0.75, 1.0))
        sx = sy * float(aug_rng.uniform(0.85, 1.05))
        dh, dw = max(8, int(h * sy)), max(16, int(w * sx))
        for k in range(x.shape[0]):
            small = cv2.resize(x[k], (dw, dh), interpolation=cv2.INTER_LINEAR)
            x[k] = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    if aug_rng.random() < 0.5:
        import cv2

        h, w = x.shape[1], x.shape[2]
        sy = float(aug_rng.uniform(0.55, 0.85))
        nh = max(12, int(h * sy))
        y_off = int(aug_rng.integers(0, h - nh + 1))
        for k in range(x.shape[0]):
            small = cv2.resize(x[k], (w, nh), interpolation=cv2.INTER_LINEAR)
            canvas = np.empty_like(x[k])
            canvas[:y_off] = small[0]
            canvas[y_off : y_off + nh] = small
            canvas[y_off + nh :] = small[-1]
            x[k] = canvas
    return x


def normalize_det(imgs_u8) -> np.ndarray:
    imgs = imgs_u8.astype(np.float32) / 255.0
    return ((imgs - np.array(DET_MEAN, np.float32)) / np.array(DET_STD, np.float32)).astype(np.float32)


def train_det(steps: int, batch: int, lr: float, seed: int, variant: str = "mobile",
              log_every: int = 25, det_h: int = 256, det_w: int = 448, pregen: int = 0,
              device="cuda") -> str:
    """Train the DB detector (head and threshold head); returns its base
    path. ``pregen`` > 0: render (or load) that many frames once and train
    on the device (``device_loop.run_det_device_loop``); else render live in
    host threads. A head at the base path is resumed."""
    dev = resolve_device(device)
    model = flax_init(DBDetector(variant, train_outputs=True), seed).to(dev).train()
    opt = optim.Optimizer(det_optimizer(lr, steps), trainable(model))
    charset = get_charset("en")
    cfg = SynthConfig(det_h=det_h, det_w=det_w)
    base = os.path.join(models_root(), f"det_{variant}")
    start_step = 0
    if os.path.exists(base + ".npz"):
        try:
            model.load_state_dict(from_jax_det(load_flat(base + ".npz")))
            start_step = int((load_meta(base) or {}).get("step", 0))
            print(f"resuming {base} from step {start_step}")
            if restore_optimizer(opt, base, start_step):
                print("restored optimizer state (adam moments + schedule)")
        except (KeyError, ValueError, RuntimeError) as e:
            print(f"resume failed ({e}); training from scratch")

    def det_checkpoint(step):
        save_optimizer(opt, base, step)
        save_flat(to_jax_det(model.state_dict()), base, {"variant": variant, "step": step})

    t0 = time.time()

    def log(step, loss, m):
        print(f"[det] step {step} loss {loss:.4f} bce {m['shrink_bce']:.4f} "
               f"dice {m['binary_dice']:.4f} l1 {m['thresh_l1']:.4f} ({time.time() - t0:.0f}s)")

    if pregen > 0:
        if start_step >= steps:
            print(f"{base} already at step {start_step} >= {steps}; nothing to do")
            return base
        from vse_tpu_torch.train.device_loop import run_det_device_loop

        ds = load_or_render_det_dataset(pregen, det_h, det_w, seed)

        def checkpoint_cb(step):
            det_checkpoint(step)
            print(f"[det] checkpoint @ {step}")

        run_det_device_loop(
            ds=ds, step_core=lambda b: det_step(model, opt, b), steps=steps,
            start_step=start_step, batch=batch, seed=seed, device=dev,
            checkpoint_cb=checkpoint_cb, log_cb=log)
    else:
        renderers: Dict[int, TextRenderer] = {}

        def make_batch(wid):
            if wid not in renderers:
                renderers[wid] = TextRenderer(charset, cfg, seed=seed * 100 + wid)
            b = renderers[wid].det_batch(batch)
            return {"det_images": normalize_det(b["det_images"]),
                    **{k: b[k] for k in DET_GT_KEYS}}

        q, stop = _prefetch(make_batch)
        try:
            for i in range(start_step, steps):
                if i > 0 and i % 500 == 0:
                    det_checkpoint(i)
                hb = {k: torch.from_numpy(v).to(dev) for k, v in q.get().items()}
                loss, metrics = det_step(model, opt, hb)
                if i % log_every == 0 or i == steps - 1:
                    log(i, float(loss), {k: float(v) for k, v in metrics.items()})
        finally:
            stop.set()
    det_checkpoint(steps)
    print(f"saved {base}")
    return base


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vse_tpu_torch.train.pretrain")
    sub = ap.add_subparsers(dest="what", required=True)
    pr = sub.add_parser("rec")
    pr.add_argument("--language", default="en")
    pr.add_argument("--steps", type=int, default=3000)
    pr.add_argument("--batch", type=int, default=64)
    pr.add_argument("--lr", type=float, default=1e-3)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--variant", default="mobile", choices=["mobile", "server"])
    pr.add_argument("--pregen", type=int, default=0,
                    help="pre-render N batches and epoch over them")
    pr.add_argument("--use-space", action="store_true", dest="use_space",
                    help="keep the space class (slower convergence)")
    pr.add_argument("--host-data", action="store_true", dest="host_data",
                    help="feed batches from the host thread instead of the "
                         "device-resident loop (debug fallback)")
    pr.add_argument("--fresh", action="store_true",
                    help="ignore an existing checkpoint; train from scratch")
    pr.add_argument("--fresh-opt", action="store_true", dest="fresh_opt",
                    help="warm-start params but re-init the optimizer with "
                         "a full LR schedule over the remaining steps")
    pr.add_argument("--hidden", type=int, default=0,
                    help="BiLSTM width override (0 = variant default; "
                         "large-vocab CJK mobile heads need 128)")
    pr.add_argument("--cnn-scale", type=float, default=0.0, dest="cnn_scale",
                    help="MobileNetV3 width multiplier override "
                         "(0 = variant default)")
    pren = sub.add_parser("render", help="host-only dataset pre-render")
    pren.add_argument("--language", default="en")
    pren.add_argument("--pregen", type=int, default=600)
    pren.add_argument("--batch", type=int, default=64)
    pren.add_argument("--seed", type=int, default=0)
    pren.add_argument("--det", action="store_true",
                      help="render the det dataset instead of rec crops")
    pd = sub.add_parser("det")
    pd.add_argument("--pregen", type=int, default=0,
                    help="pre-render N frames and sample from the cache")
    pd.add_argument("--steps", type=int, default=1500)
    pd.add_argument("--batch", type=int, default=16)
    pd.add_argument("--lr", type=float, default=5e-4)
    pd.add_argument("--seed", type=int, default=0)
    pd.add_argument("--variant", default="mobile", choices=["mobile", "server"])
    for p in (pr, pd):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu; without CUDA only cpu runs")
    args = ap.parse_args(argv)
    if args.what == "render":
        if args.det:
            load_or_render_det_dataset(args.pregen, seed=args.seed)
        else:
            load_or_render_rec_dataset(args.language, args.pregen, args.batch, args.seed)
        return
    if args.what == "rec":
        train_rec(args.language, args.steps, args.batch, args.lr, args.seed,
                  args.variant, pregen=args.pregen, use_space=args.use_space,
                  device_data=not args.host_data, fresh=args.fresh,
                  fresh_opt=args.fresh_opt, hidden=args.hidden,
                  cnn_scale=args.cnn_scale, device=args.device)
    else:
        train_det(args.steps, args.batch, args.lr, args.seed, args.variant,
                  pregen=args.pregen, device=args.device)


if __name__ == "__main__":
    main()

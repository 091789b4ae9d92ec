"""The OCR engine: det + rec in one device step (the port of
``vse_tpu/pipeline/ocr_engine.py``).

One ``ocr_step`` runs letterbox -> DB det -> box extraction -> boxes to
frame coords -> y-expanded, ink-tight two-pass crops (or, with
``rectify``, perspective-rectified crops of oriented quads) -> CRNN ->
greedy CTC decode (kernel K1, one launch a chunk), with the boxes on the
device throughout.
The models, the letterbox and the crops reproduce the JAX engine's bf16
numerics (``models/bf16.py``); on the card the two models' forwards replay
as CUDA graphs (``models/graphed.py``).
``predict_batch`` returns the reference's per-frame ``(dt_box, rec_res)``:
quads as 4 (x, y) points, ``[(text, prob)]``, lines sorted top to bottom
and boxes left to right (reference backend/tools/ocr.py:16-22,44-79).

A language resolves to its script family as the reference's registry
resolves it (``core/charset.py::script_family``); the family names the
exported rec head (``checkpoints_torch/rec_<family>_mobile``), whose
``vse_meta.json`` gives the charset variant it was trained on
(``head_charset``). Every family runs but japan and chinese_cht, whose
heads are not exported yet. Decoded text goes through the reference's
script post-pass (``_to_logical``): visual -> logical order for arabic, the
homoglyph fold for cyrillic and el.

The mode picks the models as the reference's registry does
(``core/registry.py::resolve``): fast runs the PP-OCRv3 mobile det
(``models/ppocr_det.py``), accurate the server det
(``models/db_detector.py`` on the exported ``det_server`` weights), and
auto the server det when accelerated (``config.hardware_acceleration`` on
a CUDA device, as the JAX package's accelerator check) and the mobile one
otherwise. A server rec head is never exported, so the rec falls back to
the family's mobile head, as the reference's engine falls back.

``detect_batch`` is the det alone (the reference's det-only letterbox,
``letterbox_resize``). ``decode="beam"`` runs that det, then the rec on
f32 crops of the whole frame height and a host prefix beam
(``ops/ctc.py``) over the log-softmax of its logits; K1 is not launched
there.

``mesh`` (``parallel/sharding.py::make_mesh``): one det and rec replica on
each device of the mesh's ``data`` axis, loaded once and copied, each with
its own CUDA graphs. ``predict_batch`` and ``detect_batch`` pad each chunk
with zero frames up to a multiple of the data size (the JAX engine's
``_shard_frames``), OCR one contiguous piece of it on each replica (K1 once
a piece; its counter counts every replica's launches), gather the results
in order and drop the padding rows. Nothing is exchanged between the
devices. The beam path runs on the first replica.

Spans and counters (``utils/tracing.py``, no-ops unless recording):
``ocr_arrays`` records ``ocr.step`` (attr ``frames``, their shape) around
the step's parts ``ocr.letterbox``, ``ocr.det`` and ``ocr.rec`` (each
forward, attr ``input``, its shape), ``ocr.postprocess`` (the DB
postprocess and the boxes to frame coords), ``ocr.crops``, ``ocr.k1`` and
``ocr.fetch`` (the results' copy to the host), then the counters
``ocr.crops`` (the rec's crops, every box slot of every frame) and
``ocr.boxes`` (the slots that hold a box); ``predict_batch`` records
``ocr.format`` (the host's texts and line sorting). On the card the spans
time the host's enqueue, and ``ocr.fetch`` the wait for the device.
"""

from __future__ import annotations

import copy
import os
import warnings
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from vse_tpu_torch.core.arabic import HOMOGLYPHS, visual_to_logical
from vse_tpu_torch.core.charset import Charset, get_charset, to_jamo
from vse_tpu_torch.core.config import Mode, VseConfig
from vse_tpu_torch.core.registry import ModelSpec, resolve
from vse_tpu_torch.device import resolve_device
from vse_tpu_torch.kernels import ctc_decode as k1
from vse_tpu_torch.kernels.ctc_decode import ctc_greedy_decode
from vse_tpu_torch.models.bf16 import emulate, fma
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.db_detector import DBDetector
from vse_tpu_torch.models.graphed import GraphedForward
from vse_tpu_torch.models.ppocr_det import PPOCRv3DetMobile
from vse_tpu_torch.ops.ctc import ctc_prefix_beam_decode
from vse_tpu_torch.ops.db_postprocess import db_postprocess
from vse_tpu_torch.ops.image import (
    crop_boxes_windowed, crop_quads_rectified_windowed, letterbox_matmul, letterbox_resize,
    normalize_det, quads_from_boxes, recip, refine_boxes_ink,
)
from vse_tpu_torch.parallel.sharding import data_sharding
from vse_tpu_torch.post.homoglyph import normalize_script
from vse_tpu_torch.utils.tracing import annotate, count, recording
from vse_tpu_torch.weights import (
    from_jax_params, load_det_npz, load_det_server, load_rec_flat, load_rec_meta,
    rec_head_paths,
)


def y_round(y: int) -> int:
    """Round a ymin to the nearest multiple of 10 (reference
    backend/tools/ocr.py:16-22)."""
    up = y + 10 - y % 10
    down = y - y % 10
    return up if abs(y - up) < abs(y - down) else down


def sort_into_lines(
    coords: List[Tuple[int, int, int, int]], items: List[Any]
) -> Tuple[List[Tuple[int, int, int, int]], List[Any]]:
    """Group boxes into text lines by rounded ymin and order them
    (line-y asc, then x asc) — the reference's ranking (ocr.py:44-79)."""
    lines: List[int] = []
    for c in coords:
        ry = y_round(c[2])
        if not lines:
            lines.append(ry)
        elif ry not in lines and ry + 10 not in lines and ry - 10 not in lines:
            lines.append(ry)
    lines = sorted(lines)
    snapped = []
    for c in coords:
        ry = y_round(c[2])
        best = c[2]
        for ln in lines:
            if abs(ln - ry) <= 10:
                best = ln
                break
        snapped.append((c[0], c[1], best, c[3]))
    order = sorted(range(len(coords)), key=lambda i: (snapped[i][2], snapped[i][0]))
    return [snapped[i] for i in order], [items[i] for i in order]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def expand_boxes_y(boxes: torch.Tensor, frac: float, h: int) -> torch.Tensor:
    """Expand xyxy boxes vertically by ``frac`` of their height per side,
    clamped to the frame (crop stage only; reported boxes stay unexpanded)."""
    if frac <= 0:
        return boxes
    bh = boxes[..., 3] - boxes[..., 1]
    return torch.stack(
        [
            boxes[..., 0],
            torch.clamp(fma(-bh, frac, boxes[..., 1]), 0, h - 1),
            boxes[..., 2],
            torch.clamp(fma(bh, frac, boxes[..., 3]), 0, h - 1),
        ],
        dim=-1,
    )


def crops_tight(frames: torch.Tensor, boxes: torch.Tensor, rec_h: int,
                rec_w: int, cfg: VseConfig, frame_h: int,
                window_rows: int = 288) -> torch.Tensor:
    """Rec crops [B, K, rec_h, rec_w, 3] with the ink-tight two-pass policy:
    a provisional crop from the expanded boxes, its vertical ink band, then
    a re-crop of the ORIGINAL frame to ink + margin. ``window_rows`` at the
    frame height is the reference's unwindowed crop."""
    crops0 = crop_boxes_windowed(frames, boxes, rec_h, rec_w, window_rows)
    if not cfg.rec_crop_tighten:
        return crops0
    refined = refine_boxes_ink(crops0, boxes, cfg.rec_crop_tight_margin, frame_h)
    return crop_boxes_windowed(frames, refined, rec_h, rec_w, window_rows)


def rec_normalize(crops: torch.Tensor) -> torch.Tensor:
    """``(crops / 255 - 0.5) / 0.5`` as XLA compiles it."""
    return fma(crops, recip(255.0).to(crops.device), -0.5) * 2.0


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis, in its order of ops."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def head_charset(language: str, rec_meta: dict) -> Charset:
    """The charset whose classes a rec head was trained on: the language's
    charset with the head's ``vse_meta.json`` options applied in the JAX
    engine's order (``vse_tpu/pipeline/ocr_engine.py``: case fold, no
    space class, positional jamo, homoglyph fold)."""
    cs = get_charset(language)
    if rec_meta.get("fold_case", False):
        cs = cs.folded()
    if not rec_meta.get("use_space_char", True):
        cs = cs.without_space()
    if rec_meta.get("jamo", False):
        cs = to_jamo(cs)
    if rec_meta.get("homoglyph_fold", False):
        cs = cs.aliased(HOMOGLYPHS)
    return cs


@dataclass
class Replica:
    """The det and rec on one device, with their graphed forwards, and the
    K1 launches its OCR steps made."""

    device: torch.device
    det_model: torch.nn.Module
    rec_model: torch.nn.Module
    det_forward: GraphedForward
    rec_forward: GraphedForward
    k1_launches: int = 0

    @classmethod
    def of(cls, det_model, rec_model, device) -> "Replica":
        det_model.to(device).eval()
        rec_model.to(device).eval()
        return cls(device, det_model, rec_model, GraphedForward(det_model),
                   GraphedForward(rec_model))


class OcrEngine:
    """Detector + recognizer on one device (or one replica on each device
    of a mesh's data axis), in mode fast, auto or accurate, with greedy
    (kernel K1) or beam decode."""

    def __init__(
        self,
        language: str = "en",
        mode: Mode = Mode.FAST,
        config: Optional[VseConfig] = None,
        device: Union[str, torch.device] = "cuda",
        accelerated: Optional[bool] = None,
        decode: str = "greedy",
        beam_width: int = 8,
        rectify: Optional[bool] = None,
        mesh=None,
    ):
        """``accelerated`` (auto mode's choice of the server models) defaults
        to ``config.hardware_acceleration`` on a CUDA device. ``decode``:
        'greedy' (kernel K1) or 'beam' (host prefix beam of ``beam_width``
        over device log-probs). ``rectify`` (default
        ``config.rec_rectify``): rectified crops of oriented quads.
        ``mesh``: a ``parallel.sharding.Mesh``; its data axis's devices
        take the place of ``device`` (None: one device)."""
        self.config = config or VseConfig(language=language, mode=mode)
        if mesh is not None:
            for d in mesh.data_devices:
                resolve_device(d)
            device = mesh.data_devices[0]
        self.device = resolve_device(device)
        self.mode = Mode(mode)
        if decode not in ("greedy", "beam"):
            raise ValueError(f"decode must be 'greedy' or 'beam', got {decode!r}")
        if accelerated is None:
            accelerated = self.config.hardware_acceleration and self.device.type == "cuda"
        self.language = language
        self.spec: ModelSpec = resolve(language, self.mode, accelerated)
        self.family = self.spec.rec_family
        get_charset(language)  # raises for a family not ported
        # server -> mobile rec fallback: no server head is exported, as the
        # reference's engine falls back when its checkpoint is missing
        self.rec_variant = self.spec.rec_variant
        if self.rec_variant == "server" and not os.path.exists(
                rec_head_paths(self.family, "server")[0]):
            self.rec_variant = "mobile"
        rec_meta = load_rec_meta(self.family, self.rec_variant)
        if rec_meta is None:
            raise FileNotFoundError(
                f"no exported rec head at {rec_head_paths(self.family, self.rec_variant)[0]}; "
                "export one with tools/export_torch_weights.py"
            )
        # the head's class count and order are part of its weights
        self.charset = head_charset(language, rec_meta)
        head_geo = rec_meta.get("geometry", "expand_y")
        want_geo = "tight1" if self.config.rec_crop_tighten else "expand_y"
        if head_geo != want_geo:
            warnings.warn(
                f"rec head was trained for crop geometry {head_geo!r} but the "
                f"engine runs {want_geo!r} (config.rec_crop_tighten) — "
                "recognition quality will degrade",
                stacklevel=2,
            )
        self.rec_model = CRNNRecognizer(
            vocab_size=self.charset.vocab_size,
            hidden=int(rec_meta.get("hidden", 0) or 0),
            cnn_scale=float(rec_meta.get("cnn_scale", 0.0) or 0.0),
            variant=rec_meta.get("variant", self.rec_variant),
        )
        self.rec_model.load_state_dict(
            from_jax_params(load_rec_flat(self.family, self.rec_variant)))
        if self.spec.det_variant == "server":
            self.det_model = DBDetector("server")
            self.det_model.load_state_dict(load_det_server(self.spec.det_ckpt))
        else:
            self.det_model = PPOCRv3DetMobile()
            self.det_model.load_state_dict(load_det_npz())
        # both models run the reference's bf16 numerics (models/bf16.py)
        emulate(self.rec_model)
        emulate(self.det_model)
        devices = mesh.data_devices if mesh is not None else [self.device]
        self._data_sharding = data_sharding(mesh) if mesh is not None else None
        self.replicas = [Replica.of(self.det_model, self.rec_model, devices[0])]
        self.replicas += [Replica.of(copy.deepcopy(self.det_model), copy.deepcopy(self.rec_model), d)
                          for d in devices[1:]]
        self.det_forward = self.replicas[0].det_forward
        self.rec_forward = self.replicas[0].rec_forward
        self.rec_h = self.config.rec_image_height
        self.rec_w = self.config.rec_image_width
        self.max_boxes = self.config.max_boxes_per_frame
        self.decode = decode
        self.beam_width = beam_width
        self.rectify = self.config.rec_rectify if rectify is None else rectify

    def det_bucket(self, h: int, w: int) -> Tuple[int, int]:
        """Det canvas: multiples of 32 (backbone stride), capped by the
        configured det size."""
        return (
            min(_round_up(h, 32), _round_up(self.config.det_image_height, 32)),
            min(_round_up(w, 32), _round_up(self.config.det_image_width, 32)),
        )

    @torch.inference_mode()
    def ocr_step(self, frames: torch.Tensor, replica: Optional[Replica] = None):
        """The OCR step on device frames [B, h, w, 3] uint8, on ``replica``
        (default the first; ``frames`` on its device). Returns device
        tensors (boxes [B,K,4] frame coords, det_scores [B,K], valid [B,K],
        ids [B,K,T], mask [B,K,T], rec_scores [B,K])."""
        rep = replica or self.replicas[0]
        cfg = self.config
        B, h, w, _ = frames.shape
        hd, wd = self.det_bucket(h, w)
        with annotate("ocr.letterbox"):
            x, (inv_y, inv_x) = letterbox_matmul(frames, hd, wd)
        with annotate("ocr.det", input=x):
            prob = rep.det_forward(x)
        with annotate("ocr.postprocess"):
            boxes, det_scores, valid, angles = db_postprocess(
                prob,
                max_boxes=self.max_boxes,
                thresh=cfg.db_thresh,
                box_thresh=cfg.db_box_thresh,
                unclip_ratio=cfg.db_unclip_ratio,
                pool=cfg.db_pool,
                num_sweeps=cfg.db_sweeps,
            )
            boxes = torch.stack(
                [
                    torch.clamp(boxes[..., 0] * inv_x, 0, w - 1),
                    torch.clamp(boxes[..., 1] * inv_y, 0, h - 1),
                    torch.clamp(boxes[..., 2] * inv_x, 0, w - 1),
                    torch.clamp(boxes[..., 3] * inv_y, 0, h - 1),
                ],
                dim=-1,
            )
        with annotate("ocr.crops"):
            if self.rectify:
                # quads from the unexpanded boxes: the oriented fit frames the
                # glyphs without the axis-aligned path's y-expansion
                crops = crop_quads_rectified_windowed(
                    frames.float(), quads_from_boxes(boxes, angles), self.rec_h, self.rec_w)
            else:
                crop_boxes = expand_boxes_y(boxes, cfg.rec_crop_expand_y, h)
                crops = crops_tight(frames, crop_boxes, self.rec_h, self.rec_w, cfg, h)
            K = crops.shape[1]
            crops = rec_normalize(crops.reshape((B * K,) + tuple(crops.shape[2:])))
        with annotate("ocr.rec", input=crops):
            logits = rep.rec_forward(crops).contiguous()
        with annotate("ocr.k1"):
            before = k1.launches
            ids, mask, rec_scores = ctc_greedy_decode(logits)
            rep.k1_launches += k1.launches - before
        T = ids.shape[1]
        return (
            boxes, det_scores, valid,
            ids.reshape(B, K, T), mask.reshape(B, K, T), rec_scores.reshape(B, K),
        )

    def predict_batch(
        self, frames_u8: Union[np.ndarray, torch.Tensor],
        origin: Tuple[int, int] = (0, 0),
    ) -> List[Tuple[list, list]]:
        """Full OCR on a frame batch [B, h, w, 3] uint8 — a host array, or a
        tensor such as ``device_prefetch`` yields — in chunks of
        ``max_batch_size``. ``origin=(dy, dx)`` is added to the output boxes
        (callers that pass only the subtitle band get full-frame coords)."""
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        frames_u8 = frames_u8.to(self.device)
        if self.decode == "beam":
            return self._predict_batch_beam(frames_u8, origin)
        B = frames_u8.shape[0]
        chunk = max(1, self.config.max_batch_size)
        out: List[Tuple[list, list]] = []
        for i in range(0, B, chunk):
            fr = frames_u8[i : i + chunk]
            boxes, _, valid, ids, mask, rec_scores = self.ocr_arrays(fr)
            with annotate("ocr.format"):
                out.extend(self._format_results(
                    fr.shape[0], boxes, valid, ids, mask, rec_scores, origin
                ))
        return out

    def ocr_arrays(self, frames_u8: torch.Tensor) -> List[np.ndarray]:
        """The OCR step on one chunk of device frames, spread over the
        replicas: host arrays (boxes, det_scores, valid, ids, mask,
        rec_scores), one row a frame."""
        with annotate("ocr.step", frames=frames_u8):
            out = self._on_replicas(self.ocr_step, frames_u8)
        if recording():
            count("ocr.crops", out[2].size)
            count("ocr.boxes", out[2].sum())
        return out

    def _on_replicas(self, step, frames: torch.Tensor) -> List[np.ndarray]:
        """``step(piece, replica)`` on each replica's contiguous piece of
        ``frames`` (padded with zero frames to a multiple of the replica
        count), every piece issued before any result is read; the results
        as host arrays in frame order, the padding rows dropped."""
        if self._data_sharding is None:
            out = step(frames, self.replicas[0])
            with annotate("ocr.fetch"):
                return [r.cpu().numpy() for r in out]
        B = frames.shape[0]
        pad = (-B) % len(self.replicas)
        if pad:
            frames = torch.cat([frames, frames.new_zeros((pad,) + tuple(frames.shape[1:]))])
        results = [step(piece, rep) for piece, rep in
                   zip(self._data_sharding.shard(frames), self.replicas)]
        with annotate("ocr.fetch"):
            return [np.concatenate([res[k].cpu().numpy() for res in results])[:B]
                    for k in range(len(results[0]))]

    @torch.inference_mode()
    def detect_batch(self, frames_u8: Union[np.ndarray, torch.Tensor]):
        """The det alone (the reference's det-only role): frames [B, h, w, 3]
        uint8 -> numpy (boxes [B, K, 4] xyxy in frame coords, det_scores
        [B, K], valid [B, K]), through the reference's det-only letterbox."""
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        frames_u8 = frames_u8.to(self.device)
        _, h, w, _ = frames_u8.shape
        hd, wd = self.det_bucket(h, w)
        inv_scale = 1.0 / min(hd / h, wd / w)  # letterbox_resize's
        boxes, scores, valid = self._on_replicas(self._detect_step, frames_u8)
        # on the host in f32, as the reference scales them
        boxes = boxes * inv_scale
        boxes[..., 0::2] = boxes[..., 0::2].clip(0, w - 1)
        boxes[..., 1::2] = boxes[..., 1::2].clip(0, h - 1)
        return boxes, scores, valid

    def _detect_step(self, frames_u8: torch.Tensor, rep: Replica):
        """The det alone on ``rep``: canvas boxes, scores and valid."""
        cfg = self.config
        hd, wd = self.det_bucket(*frames_u8.shape[1:3])
        canvas, _ = letterbox_resize(frames_u8, hd, wd)
        prob = rep.det_forward(normalize_det(canvas))
        boxes, scores, valid, _ = db_postprocess(
            prob,
            max_boxes=self.max_boxes,
            thresh=cfg.db_thresh,
            box_thresh=cfg.db_box_thresh,
            unclip_ratio=cfg.db_unclip_ratio,
            pool=cfg.db_pool,
            num_sweeps=cfg.db_sweeps,
        )
        return boxes, scores, valid

    @torch.inference_mode()
    def crop_logits(self, frames_u8: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Crops of the boxes [B, K, 4] (frame coords) from f32 frames,
        sampled over the whole frame height, through the rec -> log-probs
        [B, K, T, C] (the reference's ``_crop_logits_fn``)."""
        _, h, _, _ = frames_u8.shape
        boxes = expand_boxes_y(boxes, self.config.rec_crop_expand_y, h)
        crops = crops_tight(frames_u8.float(), boxes, self.rec_h, self.rec_w,
                            self.config, h, window_rows=h)
        B, K = crops.shape[:2]
        crops = rec_normalize(crops.reshape((B * K,) + tuple(crops.shape[2:])))
        logp = log_softmax(self.rec_forward(crops))
        return logp.reshape((B, K) + tuple(logp.shape[1:]))

    def _predict_batch_beam(self, frames_u8: torch.Tensor,
                            origin: Tuple[int, int] = (0, 0)) -> List[Tuple[list, list]]:
        """Beam decode: the det alone, device log-probs of the crops, then a
        host prefix beam over each valid box's log-probs, in the reference's
        ``rec_batch_number`` groups."""
        B = frames_u8.shape[0]
        boxes, _, valid = self.detect_batch(frames_u8)
        logp = self.crop_logits(frames_u8, torch.from_numpy(boxes).to(self.device)).cpu().numpy()
        todo = [(b, k) for b in range(B) for k in range(self.max_boxes) if valid[b, k]]
        reads = {}
        group = max(1, self.config.rec_batch_number)
        for gi in range(0, len(todo), group):
            for b, k in todo[gi : gi + group]:
                ids, score = ctc_prefix_beam_decode(logp[b, k], beam_width=self.beam_width)
                reads[(b, k)] = (self._to_logical(self.charset.decode_ids(ids)), score)
        dy, dx = origin
        out = []
        for b in range(B):
            coords, items = [], []
            for k in range(self.max_boxes):
                if not valid[b, k]:
                    continue
                x0, y0, x1, y1 = boxes[b, k]
                coords.append((int(x0 + dx), int(x1 + dx), int(y0 + dy), int(y1 + dy)))
                items.append(reads[(b, k)])
            coords, items = sort_into_lines(coords, items)
            out.append(([[(c[0], c[2]), (c[1], c[2]), (c[1], c[3]), (c[0], c[3])]
                         for c in coords], items))
        return out

    def _to_logical(self, text: str) -> str:
        """The reference's script-aware decode post-pass
        (``vse_tpu/pipeline/ocr_engine.py::_to_logical``): visual -> logical
        order for arabic, the homoglyph fold for cyrillic and el, the
        identity for every other family."""
        if not text:
            return text
        if self.family == "arabic":
            return visual_to_logical(text)
        if self.family in ("cyrillic", "el"):
            return normalize_script(text, self.family)
        return text

    def _format_results(self, B, boxes, valid, ids, mask, rec_scores,
                        origin=(0, 0)):
        """ids/mask -> texts, reference output format + line sorting."""
        dy, dx = origin
        out = []
        for b in range(B):
            coords = []
            items = []
            for k in range(self.max_boxes):
                if not valid[b, k]:
                    continue
                x0, y0, x1, y1 = boxes[b, k]
                x0, x1, y0, y1 = x0 + dx, x1 + dx, y0 + dy, y1 + dy
                text = self._to_logical(self.charset.decode_ids(
                    [int(i) for i, m in zip(ids[b, k], mask[b, k]) if m]
                ))
                coords.append((int(x0), int(x1), int(y0), int(y1)))
                items.append((text, float(rec_scores[b, k])))
            coords, items = sort_into_lines(coords, items)
            dt_box = [
                [(c[0], c[2]), (c[1], c[2]), (c[1], c[3]), (c[0], c[3])]
                for c in coords
            ]
            out.append((dt_box, items))
        return out

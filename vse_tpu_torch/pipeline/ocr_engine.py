"""The OCR engine: det + rec in one device step (the port of the fast greedy
path of ``vse_tpu/pipeline/ocr_engine.py``).

One ``ocr_step`` runs letterbox -> PP-OCRv3 DB det -> pooled box extraction
-> boxes to frame coords -> y-expanded, ink-tight two-pass crops -> CRNN ->
greedy CTC decode (kernel K1), with the boxes on the device throughout.
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

Not ported in this slice: rectified crops, beam decode, a device mesh, the
server det/rec variants (modes auto and accurate), ``detect_batch``.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from vse_tpu_torch.core.arabic import HOMOGLYPHS, visual_to_logical
from vse_tpu_torch.core.charset import Charset, get_charset, script_family, to_jamo
from vse_tpu_torch.core.config import Mode, VseConfig
from vse_tpu_torch.device import resolve_device
from vse_tpu_torch.kernels.ctc_decode import ctc_greedy_decode
from vse_tpu_torch.models.bf16 import emulate, fma
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.graphed import GraphedForward
from vse_tpu_torch.models.ppocr_det import PPOCRv3DetMobile
from vse_tpu_torch.ops.db_postprocess import db_postprocess
from vse_tpu_torch.ops.image import (
    crop_boxes_windowed, letterbox_matmul, recip, refine_boxes_ink,
)
from vse_tpu_torch.post.homoglyph import normalize_script
from vse_tpu_torch.weights import (
    from_jax_params, load_det_npz, load_rec_flat, load_rec_meta, rec_head_paths,
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
                rec_w: int, cfg: VseConfig, frame_h: int) -> torch.Tensor:
    """Rec crops [B, K, rec_h, rec_w, 3] with the ink-tight two-pass policy:
    a provisional crop from the expanded boxes, its vertical ink band, then
    a re-crop of the ORIGINAL frame to ink + margin."""
    crops0 = crop_boxes_windowed(frames, boxes, rec_h, rec_w)
    if not cfg.rec_crop_tighten:
        return crops0
    refined = refine_boxes_ink(crops0, boxes, cfg.rec_crop_tight_margin, frame_h)
    return crop_boxes_windowed(frames, refined, rec_h, rec_w)


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


class OcrEngine:
    """Detector + recognizer on one device, fast mode, greedy decode."""

    def __init__(
        self,
        language: str = "en",
        mode: Mode = Mode.FAST,
        config: Optional[VseConfig] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config or VseConfig(language=language, mode=mode)
        self.device = resolve_device(device)
        if Mode(mode) != Mode.FAST:
            raise NotImplementedError(
                f"mode {Mode(mode).value!r} needs the server det/rec models, "
                "which are not ported yet; use mode 'fast'"
            )
        self.language = language
        self.family = script_family(language)
        get_charset(language)  # raises for a family not ported
        rec_meta = load_rec_meta(self.family)
        if rec_meta is None:
            raise FileNotFoundError(
                f"no exported rec head at {rec_head_paths(self.family)[0]}; "
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
        )
        self.rec_model.load_state_dict(from_jax_params(load_rec_flat(self.family)))
        self.det_model = PPOCRv3DetMobile()
        self.det_model.load_state_dict(load_det_npz())
        # both models run the reference's bf16 numerics (models/bf16.py)
        emulate(self.rec_model)
        emulate(self.det_model)
        self.det_forward = GraphedForward(self.det_model)
        self.rec_forward = GraphedForward(self.rec_model)
        self.rec_model.to(self.device).eval()
        self.det_model.to(self.device).eval()
        self.rec_h = self.config.rec_image_height
        self.rec_w = self.config.rec_image_width
        self.max_boxes = self.config.max_boxes_per_frame

    def det_bucket(self, h: int, w: int) -> Tuple[int, int]:
        """Det canvas: multiples of 32 (backbone stride), capped by the
        configured det size."""
        return (
            min(_round_up(h, 32), _round_up(self.config.det_image_height, 32)),
            min(_round_up(w, 32), _round_up(self.config.det_image_width, 32)),
        )

    @torch.inference_mode()
    def ocr_step(self, frames: torch.Tensor):
        """The OCR step on device frames [B, h, w, 3] uint8. Returns device
        tensors (boxes [B,K,4] frame coords, det_scores [B,K], valid [B,K],
        ids [B,K,T], mask [B,K,T], rec_scores [B,K])."""
        cfg = self.config
        B, h, w, _ = frames.shape
        hd, wd = self.det_bucket(h, w)
        x, (inv_y, inv_x) = letterbox_matmul(frames, hd, wd)
        prob = self.det_forward(x)
        boxes, det_scores, valid, _ = db_postprocess(
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
        crop_boxes = expand_boxes_y(boxes, cfg.rec_crop_expand_y, h)
        crops = crops_tight(frames, crop_boxes, self.rec_h, self.rec_w, cfg, h)
        K = crops.shape[1]
        crops = crops.reshape((B * K,) + tuple(crops.shape[2:]))
        crops = fma(crops, recip(255.0).to(crops.device), -0.5) * 2.0
        logits = self.rec_forward(crops).contiguous()
        ids, mask, rec_scores = ctc_greedy_decode(logits)
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
        B = frames_u8.shape[0]
        chunk = max(1, self.config.max_batch_size)
        out: List[Tuple[list, list]] = []
        for i in range(0, B, chunk):
            fr = frames_u8[i : i + chunk]
            res = self.ocr_step(fr)
            boxes, _, valid, ids, mask, rec_scores = (r.cpu().numpy() for r in res)
            out.extend(self._format_results(
                fr.shape[0], boxes, valid, ids, mask, rec_scores, origin
            ))
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

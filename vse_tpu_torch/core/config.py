"""Typed configuration for the extraction pipeline: the fields of the JAX
package's ``VseConfig`` that the port's main path reads, with the same names,
defaults and value checks (reference backend/config.py:50-98 for the
reference-derived knobs). Later slices add fields as they port what reads
them.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Mode(str, Enum):
    """Recognition mode (reference backend/config.py:54).

    fast     — keyframe scanner + mobile models
    auto     — keyframe scanner + server models on accelerator, mobile on CPU
    accurate — per-frame DB detection + span segmentation (reference
               backend/main.py:255-376)
    """

    AUTO = "auto"
    FAST = "fast"
    ACCURATE = "accurate"


@dataclass(frozen=True)
class VseConfig:
    """Pipeline knobs the main path reads."""

    # Subtitle language (reference backend/config.py:52)
    language: str = "ch"
    # Recognition mode (reference backend/config.py:54)
    mode: Mode = Mode.FAST
    # Emit a .txt transcript next to the .srt (reference backend/config.py:56)
    generate_txt: bool = False
    # Frames per det batch (reference backend/config.py:60)
    max_batch_size: int = 10
    # Frames sampled per second of video in fps mode, and inside keyframe
    # spans (reference backend/config.py:64)
    extract_frequency: int = 3
    # Coordinate-similarity tolerances for watermark unification
    # (reference backend/config.py:66-68)
    tolerant_pixel_y: int = 50
    tolerant_pixel_x: int = 100
    # Scene-text filter band expansion, and the upload-band margin around
    # an area (reference backend/config.py:70)
    subtitle_area_deviation_pixel: int = 50
    # Top-N candidate watermark areas (reference backend/config.py:71)
    watermark_area_num: int = 5
    # Dedup similarity threshold, percent (reference backend/config.py:76)
    threshold_text_similarity: int = 80
    # Drop OCR lines below this confidence, percent (reference backend/config.py:78)
    drop_score: int = 75
    # Allowed box overflow outside the subtitle area, fraction
    # (reference backend/config.py:80)
    subtitle_area_deviation_rate: float = 0.0
    # Keep/drop keyframe-timeline cues with no recognized text
    # (reference backend/config.py:87)
    delete_empty_timestamp: bool = True
    # Re-segment words / punctuation fixes (reference backend/config.py:89)
    word_segmentation: bool = True

    # --- device-pipeline knobs (no reference equivalent) ---
    # Frames per OCR batch (fps strategy and the keyframe OCR pass).
    frame_batch: int = 8
    # Max text boxes per frame (fixed output shapes).
    max_boxes_per_frame: int = 8
    # Recognizer input height/width (PP-OCR v3 uses 48x320;
    # reference backend/tools/paddle_model_config.py:93-97).
    rec_image_height: int = 48
    rec_image_width: int = 320
    # DB postprocess (PaddleOCR defaults thresh .3, box_thresh .6, unclip
    # 1.6); components are labelled on a db_pool-x max-pooled map with
    # db_sweeps label-propagation sweeps.
    db_thresh: float = 0.3
    db_box_thresh: float = 0.6
    db_unclip_ratio: float = 1.6
    db_pool: int = 8
    db_sweeps: int = 2
    # Vertical expansion of det boxes before rec cropping, as a fraction of
    # box height per side (the DB shrink core clips glyph caps/descenders);
    # reported det boxes are not expanded.
    rec_crop_expand_y: float = 0.45
    # Ink-tight rec re-crop: measure the provisional crop's vertical ink band
    # and re-crop the frame to ink + margin (heads record this geometry as
    # "tight1" in vse_meta.json).
    rec_crop_tighten: bool = True
    rec_crop_tight_margin: float = 0.07
    # Detection canvas bound (H, W): frames are letterboxed into it
    # (PaddleOCR's det_limit_side_len=960).
    det_image_height: int = 576
    det_image_width: int = 960

    def __post_init__(self):
        if isinstance(self.mode, str) and not isinstance(self.mode, Mode):
            object.__setattr__(self, "mode", Mode(self.mode))
        if not 1 <= self.max_batch_size <= 256:
            raise ValueError("max_batch_size must be in [1, 256]")
        if not 1 <= self.extract_frequency <= 60:
            raise ValueError("extract_frequency must be in [1, 60]")
        if not 0 <= self.threshold_text_similarity <= 100:
            raise ValueError("threshold_text_similarity must be in [0, 100]")
        if not 0 <= self.drop_score <= 100:
            raise ValueError("drop_score must be in [0, 100]")

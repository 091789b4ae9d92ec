"""Typed configuration for the extraction pipeline: the fields of the JAX
package's ``VseConfig`` that the port reads, with the same names, defaults
and value checks (reference backend/config.py:50-98 for the
reference-derived knobs), and the reference's ``config.json`` interop
(``from_json``, ``to_json``): every key of the reference's ``"Main"``
section maps onto a field, so a user's config carries over. Fields that
only the JAX package's later modes and devices read (its TPU knobs) are not
kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


class Decoder(str, Enum):
    """Video decode backend for the keyframe scanner (reference
    backend/tools/constant.py VideoSubFinderDecoder). The port decodes with
    OpenCV; the ffmpeg decoder is not ported."""

    OPENCV = "opencv"
    FFMPEG = "ffmpeg"


@dataclass(frozen=True)
class VseConfig:
    """Pipeline knobs."""

    # Subtitle language (reference backend/config.py:52)
    language: str = "ch"
    # Recognition mode (reference backend/config.py:54)
    mode: Mode = Mode.FAST
    # Emit a .txt transcript next to the .srt (reference backend/config.py:56)
    generate_txt: bool = False
    # Text boxes recognized per rec batch (reference backend/config.py:58)
    rec_batch_number: int = 6
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
    # Debug switches (reference backend/config.py:82-85): dump a frame whose
    # CJK-family read lost every CJK character under ``loss/`` beside the
    # video, and keep the raw OCR records as ``raw.txt`` beside the SRT
    debug_ocr_loss: bool = False
    debug_no_delete_cache: bool = False
    # Keep/drop keyframe-timeline cues with no recognized text
    # (reference backend/config.py:87)
    delete_empty_timestamp: bool = True
    # Re-segment words / punctuation fixes (reference backend/config.py:89)
    word_segmentation: bool = True
    # Use the accelerator (reference backend/config.py:91); the port's
    # entry points take their device as an argument instead
    hardware_acceleration: bool = True
    # Output directory override; empty = next to the video
    # (reference backend/config.py:95)
    save_directory: str = ""
    # Keyframe scanner worker threads; 0 = auto (reference backend/config.py:96)
    scanner_cpu_cores: int = 0
    # Video decode backend for the keyframe scanner (reference backend/config.py:98)
    scanner_decoder: Decoder = Decoder.OPENCV
    # Default subtitle selection area as ratios "ymin,ymax,xmin,xmax"
    # (reference backend/config.py:49)
    subtitle_selection_areas: str = "0.78,0.99,0.05,0.95"

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
        if isinstance(self.scanner_decoder, str) and not isinstance(
                self.scanner_decoder, Decoder):
            object.__setattr__(self, "scanner_decoder", Decoder(self.scanner_decoder))
        if not 1 <= self.rec_batch_number <= 100:
            raise ValueError("rec_batch_number must be in [1, 100]")
        if not 1 <= self.max_batch_size <= 256:
            raise ValueError("max_batch_size must be in [1, 256]")
        if not 1 <= self.extract_frequency <= 60:
            raise ValueError("extract_frequency must be in [1, 60]")
        if not 0 <= self.threshold_text_similarity <= 100:
            raise ValueError("threshold_text_similarity must be in [0, 100]")
        if not 0 <= self.drop_score <= 100:
            raise ValueError("drop_score must be in [0, 100]")

    def replace(self, **kw) -> "VseConfig":
        return dataclasses.replace(self, **kw)

    # --- reference config.json interop ------------------------------------
    # the reference's config/config.json "Main" keys (reference
    # backend/config.py:50-98) -> field names
    _JSON_KEYS = {
        "Language": "language",
        "Mode": "mode",
        "GenerateTxt": "generate_txt",
        "RecBatchNumber": "rec_batch_number",
        "MaxBatchSize": "max_batch_size",
        "ExtractFrequency": "extract_frequency",
        "TolerantPixelY": "tolerant_pixel_y",
        "TolerantPixelX": "tolerant_pixel_x",
        "SubtitleAreaDeviationPixel": "subtitle_area_deviation_pixel",
        "WaterarkAreaNum": "watermark_area_num",  # sic: the reference's key
        "ThresholdTextSimilarity": "threshold_text_similarity",
        "DropScore": "drop_score",
        "SubtitleAreaDeviationRate": "subtitle_area_deviation_rate",
        "DebugOcrLoss": "debug_ocr_loss",
        "DebugNoDeleteCache": "debug_no_delete_cache",
        "DeleteEmptyTimeStamp": "delete_empty_timestamp",
        "WordSegmentation": "word_segmentation",
        "HardwareAcceleration": "hardware_acceleration",
        "SaveDirectory": "save_directory",
        "VideoSubFinderCpuCores": "scanner_cpu_cores",
        "VideoSubFinderDecoder": "scanner_decoder",
        "SubtitleSelectionAreas": "subtitle_selection_areas",
    }

    @classmethod
    def from_json(cls, path_or_dict) -> "VseConfig":
        """Load a reference-format config.json (``{"Main": {...}}``, or the
        section itself), from a path or a parsed dict; absent keys keep
        their defaults."""
        if isinstance(path_or_dict, (str, os.PathLike)):
            with open(path_or_dict, "r", encoding="utf-8") as f:
                data = json.load(f)
        else:
            data = path_or_dict
        main = data.get("Main", data)
        kw = {}
        for jkey, fname in cls._JSON_KEYS.items():
            if jkey in main:
                v = main[jkey]
                if fname == "scanner_decoder" and isinstance(v, str):
                    v = Decoder(v.lower().replace("videosubfinderdecoder.", ""))
                kw[fname] = v
        return cls(**kw)

    def to_json(self) -> dict:
        """The reference-format dict ``{"Main": {...}}`` of every mapped
        field (enums as their values)."""
        main = {}
        for jkey, fname in self._JSON_KEYS.items():
            v = getattr(self, fname)
            main[jkey] = v.value if isinstance(v, Enum) else v
        return {"Main": main}

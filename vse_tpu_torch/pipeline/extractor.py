"""SubtitleExtractor — the pipeline entry point (the port of
``vse_tpu/pipeline/extractor.py``).

``SubtitleExtractor(video, sub_area).run()`` picks the reference's strategy
(backend/main.py:137-147):

- with a subtitle area (mode fast), the keyframe strategy:
  1. scan every frame's subtitle area with kernel K2, fed by
     ``device_prefetch``, and turn the stats into keyframe spans
     (``scan_keyframe_spans``);
  2. OCR within-span samples at ``extract_frequency`` frames per second on
     the uploaded band (``extract_frame_by_keyframe``);
  3. split spans where the text changes and keep each group's medoid read
     (``refine_keyframe_spans``);
- with no area, the fps strategy: OCR every ``fps // extract_frequency``-th
  frame, fed by ``device_prefetch``, with a resume manifest
  (``extract_frame_by_fps``), then the watermark and scene-text filters
  (reference main.py:158-171).

Then dedup and the SRT (``generate_subtitle_file``), word segmentation
(``post/reformat.py``) when ``word_segmentation`` is on, and a ``.txt``
transcript when ``generate_txt`` is on. Not ported in this slice: the
accurate and auto modes, the OCR-loss debugger and the raw-record dump.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from vse_tpu_torch.core.config import Mode, VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.device import resolve_device
from vse_tpu_torch.kernels.keyframe import ScanParams, find_spans, scan_stats_u8
from vse_tpu_torch.ops.levenshtein import ratio
from vse_tpu_torch.pipeline.feed import device_prefetch
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.pipeline.resume import ProgressManifest
from vse_tpu_torch.post.dedup import (
    generate_srt, generate_srt_from_timeline, remove_duplicate_subtitles,
)
from vse_tpu_torch.post.filters import always_yes, filter_scene_text, filter_watermark
from vse_tpu_torch.post.records import RawRecord
from vse_tpu_torch.post.reformat import execute as reformat_execute
from vse_tpu_torch.post.srt import SrtFile, SrtItem, srt_to_txt
from vse_tpu_torch.video.decode import FrameStream, Video, probe, read_frames, video_path

CJK_RE = re.compile(r"[一-龥]")

ProgressListener = Callable[[float, float], None]  # (frame_extract, ocr) 0-100


class ExtractionCancelled(Exception):
    """Raised between batches when ``SubtitleExtractor.cancel`` is set."""


def split_text_groups(samples: list, thr: float, merge_thr: float = 0.5) -> list:
    """Split an in-order run of OCR samples ``[(frame_no, text, conf,
    *payload)]`` into cue groups by text change: consecutive samples within
    ``thr`` similarity of the group head share a group, and a presence flip
    always splits. Then adjacent groups whose medoid reads agree at
    ``merge_thr`` merge back (mid-fade garbles of one cue)."""
    if not samples:
        return []
    groups = [[samples[0]]]
    for s in samples[1:]:
        head = groups[-1][0]
        presence_flip = (s[1] == "") != (head[1] == "")
        if presence_flip or (s[1] and ratio(head[1], s[1]) < thr):
            groups.append([s])
        else:
            groups[-1].append(s)
    merged = [groups[0]]
    for g in groups[1:]:
        a, b = medoid_of(merged[-1])[1], medoid_of(g)[1]
        if a and b and _merge_sim(a, b) >= merge_thr:
            merged[-1].extend(g)
        else:
            merged.append(g)
    return merged


def _merge_sim(a: str, b: str) -> float:
    """Plain ratio, plus best-window containment when one read is a fragment
    of the other (>= 3 chars and under 60% of the longer read)."""
    sim = ratio(a, b)
    short, long_ = (a, b) if len(a) <= len(b) else (b, a)
    if 3 <= len(short) < 0.6 * len(long_):
        n = len(short)
        for w in (n, min(n + 2, len(long_))):
            for i in range(0, len(long_) - w + 1):
                sim = max(sim, ratio(short, long_[i : i + w]))
    return sim


def medoid_of(group: list):
    """The group's medoid read (max summed similarity to the others),
    confidence as the tiebreak."""
    if len(group) == 1:
        return group[0]
    return max(group, key=lambda s: (sum(ratio(s[1], t[1]) for t in group), s[2]))


class SubtitleExtractor:
    """Extract hard subtitles from one video into an SRT file."""

    def __init__(
        self,
        video: Video,
        sub_area: Optional[SubtitleArea] = None,
        config: Optional[VseConfig] = None,
        engine: Optional[OcrEngine] = None,
        device: Union[str, torch.device] = "cuda",
        confirm=None,
        resume: bool = False,
    ):
        self.config = config or VseConfig()
        if self.config.mode != Mode.FAST:
            raise NotImplementedError(
                f"mode {self.config.mode.value!r} is not ported yet; use mode 'fast'"
            )
        self.device = resolve_device(device)
        self.video = video
        self.meta = probe(video)
        self.fps = self.meta.fps
        self.frame_count = self.meta.frame_count
        self.frame_height = self.meta.height
        self.sub_area = sub_area
        self.confirm = confirm
        self.resume = resume
        self._engine = engine
        self.raw_records: List[RawRecord] = []
        self.timeline = SrtFile()
        self._frame_to_ms: Dict[int, float] = {}
        path = video_path(video)
        self.subtitle_output_path = os.path.join(
            os.path.dirname(path), f"{Path(path).stem}.srt"
        )
        # progress: two channels of 0-100 (reference main.py:87-99)
        self.progress_frame_extract = 0.0
        self.progress_ocr = 0.0
        self._listeners: List[ProgressListener] = []
        # cooperative cancellation, checked between device batches
        self.cancel = threading.Event()
        # wall seconds of each pass, span and sample counts of the last run()
        self.pass_seconds: Dict[str, float] = {}
        self.n_spans = self.n_samples = 0

    @property
    def engine(self) -> OcrEngine:
        if self._engine is None:
            self._engine = OcrEngine(
                language=self.config.language, mode=self.config.mode,
                config=self.config, device=self.device,
            )
        return self._engine

    def add_progress_listener(self, fn: ProgressListener) -> None:
        """Reference contract: backend/main.py:1052-1080."""
        self._listeners.append(fn)

    def update_progress(self, frame_extract: Optional[float] = None,
                        ocr: Optional[float] = None) -> None:
        if frame_extract is not None:
            self.progress_frame_extract = frame_extract
        if ocr is not None:
            self.progress_ocr = ocr
        for fn in self._listeners:
            fn(self.progress_frame_extract, self.progress_ocr)

    def _check_cancel(self) -> None:
        if self.cancel.is_set():
            raise ExtractionCancelled(video_path(self.video))

    def frame_to_ms(self, frame_no: int) -> float:
        """Frame -> capture timestamp, else frame/fps arithmetic."""
        if frame_no in self._frame_to_ms:
            return self._frame_to_ms[frame_no]
        return float(int(frame_no / self.fps * 1000.0))

    def ms_to_frameno(self, ms: float) -> int:
        """The reference's keyframe-timeline key: ms / fps (NOT ms/1000*fps),
        self-consistent on both sides (backend/main.py:768, :413)."""
        return int(ms / self.fps)

    def _in_ab_section(self, frame_no: int) -> bool:
        ab = self.sub_area.ab_section if self.sub_area is not None else None
        return ab is None or ab.contains(frame_no)

    # --- OCR gating ---------------------------------------------------------

    def _gate_lines(self, dt_box: list, rec_res: list) -> list:
        """The reference's area/score gate (backend/tools/subtitle_ocr.py:
        20-85): [(xyxy box, text, prob)] for the lines that survive."""
        drop_score = self.config.drop_score / 100.0
        dev_rate = self.config.subtitle_area_deviation_rate
        kept = []
        for quad, (text, prob) in zip(dt_box, rec_res):
            xmin = max(quad[0][0], quad[3][0])
            xmax = min(quad[1][0], quad[2][0])
            ymin = max(quad[0][1], quad[1][1])
            ymax = min(quad[2][1], quad[3][1])
            if self.engine.family == "en":
                text = CJK_RE.sub("", text)
            if self.sub_area is not None:
                overflow = self.sub_area.overflow_area_rate(xmin, xmax, ymin, ymax)
                if overflow > dev_rate or prob <= drop_score:
                    continue
            kept.append(((int(xmin), int(xmax), int(ymin), int(ymax)), text, prob))
        return kept

    def _gate_and_record(self, frame_no: int, dt_box: list, rec_res: list) -> None:
        """Gate one frame's lines and append them as raw records; with an
        AB section, only frames inside it record."""
        if self._in_ab_section(frame_no):
            for box, text, _prob in self._gate_lines(dt_box, rec_res):
                self.raw_records.append(RawRecord(frame_no, box, text))

    def upload_band(self) -> Optional[Tuple[int, int]]:
        """Rows (y0, y1) the OCR pass uploads: the area plus a margin (so the
        overflow gate still sees straddling boxes), full width; None without
        an area or when the band is the whole frame."""
        if self.sub_area is None:
            return None
        margin = max(32, self.config.subtitle_area_deviation_pixel)
        y0 = max(0, self.sub_area.ymin - margin)
        y1 = min(self.frame_height, self.sub_area.ymax + margin)
        if y1 - y0 >= self.frame_height:
            return None
        return y0, y1

    # --- keyframe strategy -----------------------------------------------------

    def scan_keyframe_spans(self) -> list:
        """Pass 1: stats of every frame's subtitle area in batches of 32
        (kernel K2 on the card), each batch cropped on the host and uploaded
        ahead by ``device_prefetch``; the stats stay on the device until the
        pass ends. Then the spans and the raw timeline."""
        a = self.sub_area
        stream = FrameStream(self.video, batch_size=32)
        params = ScanParams()
        all_stats: List[torch.Tensor] = []
        all_nos: List[np.ndarray] = []
        crop = lambda f: f[:, a.ymin : a.ymax, a.xmin : a.xmax]  # noqa: E731
        for batch, band in device_prefetch(stream, self.device, transform=crop):
            self._check_cancel()
            n_valid = int(batch.valid.sum())
            all_stats.append(scan_stats_u8(band, params)[:n_valid])
            all_nos.append(batch.frame_nos[:n_valid])
            done = float(batch.frame_nos[n_valid - 1]) / max(1, self.frame_count)
            self.update_progress(frame_extract=done * 100)
        self._frame_to_ms.update(stream.frame_to_ms)
        if not all_stats:
            return []
        stats = torch.cat(all_stats).cpu().numpy()
        spans = find_spans(stats, np.concatenate(all_nos), params)
        self.timeline = SrtFile()
        for i, sp in enumerate(spans):
            self.timeline.append(SrtItem(
                i + 1, int(self.frame_to_ms(sp.start_frame)),
                int(self.frame_to_ms(sp.end_frame)), "",
            ))
        return spans

    def keyframe_sample_targets(self, spans) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Pass-2 targets: within-span samples at ``extract_frequency``
        frames/sec, AB-section-gated on the real span frame numbers. Returns
        (0-based decoder indices, per-sample (span_idx, frame_no))."""
        stride = max(1, int(self.fps // self.config.extract_frequency))
        wanted: List[int] = []
        metas: List[Tuple[int, int]] = []
        for si, sp in enumerate(spans):
            if not self._in_ab_section(sp.start_frame):
                continue
            for fn in range(sp.start_frame, sp.end_frame + 1, stride):
                wanted.append(fn - 1)
                metas.append((si, fn))
        return wanted, metas

    def refine_keyframe_spans(self, spans, samples) -> None:
        """Split scanner spans where the OCR text changes and record each
        group's medoid read (under the timeline key of its start). ``samples``:
        [(span_idx, frame_no, dt_box, rec_res)] in frame order per span.
        Rebuilds ``self.timeline``; textless groups keep their (empty)
        timeline cue but record nothing."""
        thr = self.config.threshold_text_similarity / 100.0
        by_span = defaultdict(list)
        for si, fn, dt_box, rec_res in samples:
            kept = self._gate_lines(dt_box, rec_res)
            text = "".join(t.replace(" ", "") for _, t, _ in kept)
            conf = float(np.mean([p for _, _, p in kept])) if kept else 0.0
            by_span[si].append((fn, text, conf, dt_box, rec_res))
        self.timeline = SrtFile()
        for si, sp in enumerate(spans):
            ss = by_span.get(si)
            if not ss:
                # a span whose samples all failed to decode keeps its empty
                # cue; AB-gated spans were never sampled and stay dropped
                if self._in_ab_section(sp.start_frame):
                    self.timeline.append(SrtItem(
                        len(self.timeline) + 1, int(self.frame_to_ms(sp.start_frame)),
                        int(self.frame_to_ms(sp.end_frame)), "",
                    ))
                continue
            groups = split_text_groups(ss, thr)
            for gi, g in enumerate(groups):
                start_f = sp.start_frame if gi == 0 else g[0][0]
                end_f = groups[gi + 1][0][0] - 1 if gi + 1 < len(groups) else sp.end_frame
                start_ms = int(self.frame_to_ms(start_f))
                self.timeline.append(SrtItem(
                    len(self.timeline) + 1, start_ms, int(self.frame_to_ms(end_f)), "",
                ))
                if not g[0][1]:
                    continue
                best = medoid_of(g)
                # recorded under the timeline key int(ms / fps), which is not
                # a frame number: the AB gate was applied to the span above
                for box, text, _prob in self._gate_lines(best[3], best[4]):
                    self.raw_records.append(RawRecord(self.ms_to_frameno(start_ms), box, text))

    def extract_frame_by_keyframe(self) -> None:
        """Pass 1 scans; pass 2 OCRs the within-span samples (decoded in one
        pass) on the uploaded band and refines the spans by text change."""
        t0 = time.perf_counter()
        spans = self.scan_keyframe_spans()
        t1 = time.perf_counter()
        wanted, metas = self.keyframe_sample_targets(spans)
        decoded = read_frames(self.video, wanted)
        pairs = [(m, f) for m, f in zip(metas, decoded) if f is not None]
        B = self.config.frame_batch
        y0, y1 = self.upload_band() or (0, self.frame_height)
        samples = []
        for i in range(0, len(pairs), B):
            self._check_cancel()
            chunk = np.stack([f for _, f in pairs[i : i + B]])
            results = self.engine.predict_batch(chunk[:, y0:y1], origin=(y0, 0))
            for (m, _), (dt_box, rec_res) in zip(pairs[i : i + B], results):
                samples.append((m[0], m[1], dt_box, rec_res))
            self.update_progress(ocr=min(100.0, (i + B) / max(1, len(pairs)) * 100))
        t2 = time.perf_counter()
        self.refine_keyframe_spans(spans, samples)
        self.pass_seconds.update(scan=t1 - t0, ocr=t2 - t1)
        self.n_spans, self.n_samples = len(spans), len(pairs)

    # --- fps strategy ----------------------------------------------------------

    def extract_frame_by_fps(self) -> None:
        """OCR every ``fps // extract_frequency``-th frame (reference
        backend/main.py:228-253) in batches of ``frame_batch``, uploaded
        ahead by ``device_prefetch``. With ``resume``, the progress manifest
        is saved every 8 batches and a run starts after the last saved
        frame."""
        t0 = time.perf_counter()
        path = video_path(self.video)
        stride = max(1, int(self.fps // self.config.extract_frequency))
        start_frame = 0
        manifest = None
        if self.resume:
            manifest = ProgressManifest.load(path, "fps")
            if manifest is not None and manifest.last_frame_no > 0:
                self.raw_records.extend(manifest.records)
                start_frame = manifest.last_frame_no
                print(f"resuming from frame {start_frame} "
                      f"({len(manifest.records)} records restored)")
            else:
                manifest = ProgressManifest(path, "fps")
        stream = FrameStream(self.video, batch_size=self.config.frame_batch,
                             stride=stride, start_frame=start_frame)
        transform, origin = None, (0, 0)
        band = self.upload_band()
        if band is not None:
            y0, y1 = band
            transform, origin = (lambda f: f[:, y0:y1]), (y0, 0)
        batches_since_save = n_samples = 0
        for batch, frames in device_prefetch(stream, self.device, transform=transform):
            self._check_cancel()
            n_valid = int(batch.valid.sum())
            results = self.engine.predict_batch(frames, origin=origin)[:n_valid]
            for i, (dt_box, rec_res) in enumerate(results):
                self._gate_and_record(int(batch.frame_nos[i]), dt_box, rec_res)
            n_samples += n_valid
            done = float(batch.frame_nos[n_valid - 1]) / max(1, self.frame_count)
            self.update_progress(frame_extract=done * 100, ocr=done * 100)
            if manifest is not None:
                batches_since_save += 1
                if batches_since_save >= 8:
                    manifest.last_frame_no = int(batch.frame_nos[n_valid - 1])
                    manifest.records = list(self.raw_records)
                    manifest.save()
                    batches_since_save = 0
        self._frame_to_ms.update(stream.frame_to_ms)
        if manifest is not None:
            manifest.clear()
        self.pass_seconds["ocr"] = time.perf_counter() - t0
        self.n_samples = n_samples

    def apply_filters(self) -> None:
        """The watermark filter (the auto text-constancy policy unless a
        ``confirm`` is given) and the scene-text filter (reference
        main.py:158-171); they run only without a subtitle area."""
        cfg = self.config
        self.raw_records = filter_watermark(
            self.raw_records,
            watermark_area_num=cfg.watermark_area_num,
            tolerant_pixel_x=cfg.tolerant_pixel_x,
            tolerant_pixel_y=cfg.tolerant_pixel_y,
            confirm=self.confirm,
        )
        self.raw_records = filter_scene_text(
            self.raw_records,
            subtitle_area_deviation_pixel=cfg.subtitle_area_deviation_pixel,
            confirm=self.confirm or always_yes,
        )

    # --- orchestration ---------------------------------------------------------

    def run(self) -> str:
        """Full pipeline (reference backend/main.py:103-191). Returns the SRT
        path."""
        t0 = time.perf_counter()
        self.update_progress(0, 0)
        self.raw_records = []
        self.pass_seconds = {}
        self.n_spans = self.n_samples = 0
        if self.sub_area is not None:
            self.extract_frame_by_keyframe()
        else:
            self.extract_frame_by_fps()
        t1 = time.perf_counter()
        if self.sub_area is None:
            self.apply_filters()
        self.generate_subtitle_file()
        if self.config.word_segmentation:
            reformat_execute(self.subtitle_output_path, self.config.language)
        self.update_progress(100, 100)
        if self.config.generate_txt:
            srt_to_txt(self.subtitle_output_path)
        self.pass_seconds["post"] = time.perf_counter() - t1
        self.pass_seconds["total"] = time.perf_counter() - t0
        print(f"extraction finished in {self.pass_seconds['total']:.1f}s -> "
              f"{self.subtitle_output_path}")
        return self.subtitle_output_path

    def generate_subtitle_file(self) -> None:
        """Dedup the raw records, then merge them into the keyframe timeline
        (keyframe strategy) or pad them into cues (fps strategy)."""
        keyframe = self.sub_area is not None
        spans = remove_duplicate_subtitles(
            self.raw_records,
            threshold_percent=self.config.threshold_text_similarity,
            single_frame_extends=not keyframe,
        )
        if keyframe:
            srt = generate_srt_from_timeline(
                self.timeline, spans, self.ms_to_frameno,
                delete_empty_timestamp=self.config.delete_empty_timestamp,
            )
        else:
            srt, _ = generate_srt(spans, self.frame_to_ms, self.fps)
        srt.save(self.subtitle_output_path)

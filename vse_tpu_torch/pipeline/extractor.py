"""SubtitleExtractor — the pipeline entry point (the port of
``vse_tpu/pipeline/extractor.py``).

``SubtitleExtractor(video, sub_area).run()`` picks the reference's strategy
(backend/main.py:137-147):

- with a subtitle area in mode accurate, per-frame detection: every frame's
  upload band through the engine (the server det), fed by
  ``device_prefetch``, and ``DetSpanTracker`` turning the per-frame reads
  into cues (``extract_frame_by_det``);
- with a subtitle area in mode fast or auto, the keyframe strategy (auto
  OCRs with whichever det its engine resolved):
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
transcript when ``generate_txt`` is on. User-facing messages go through
``append_output`` in the catalog's locale (``core/i18n.py``). The debug
switches: ``debug_no_delete_cache`` keeps the raw records as ``raw.txt``
beside the SRT (``dump_raw_records``), and ``debug_ocr_loss`` writes a
frame whose CJK-family read lost every CJK character to ``loss/`` beside
the video (``_maybe_dump_ocr_loss``; it needs OpenCV, imported only then).
``scanner_decoder`` picks the frame streams' decoder (OpenCV or ffmpeg).

Spans (``utils/tracing.py``, no-ops unless recording): ``run`` opens a clip
scope and its root span ``extract`` (attr ``video``), with ``pass.scan``,
``pass.ocr`` and ``pass.post`` beside ``pass_seconds``; the scan records
``scan.k2`` (K2's call, attr ``batch``), ``scan.fetch`` (the stats' copy
to the host) and ``scan.find_spans``; the tracker ``tracker.feed`` and
``tracker.finish``.
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
from vse_tpu_torch.core.i18n import tr
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
from vse_tpu_torch.post.records import RawRecord, write_raw
from vse_tpu_torch.post.reformat import execute as reformat_execute
from vse_tpu_torch.post.srt import SrtFile, SrtItem, srt_to_txt
from vse_tpu_torch.utils import tracing
from vse_tpu_torch.utils.tracing import annotate
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


def quad_bounds(quad) -> Tuple[float, float, float, float]:
    """(xmin, xmax, ymin, ymax) inside a quad's four corners, as the
    reference's gates read a box."""
    return (max(quad[0][0], quad[3][0]), min(quad[1][0], quad[2][0]),
            max(quad[0][1], quad[1][1]), min(quad[2][1], quad[3][1]))


def medoid_of(group: list):
    """The group's medoid read (max summed similarity to the others),
    confidence as the tiebreak."""
    if len(group) == 1:
        return group[0]
    return max(group, key=lambda s: (sum(ratio(s[1], t[1]) for t in group), s[2]))


class DetSpanTracker:
    """Accurate mode's span state machine over per-frame OCR results (the
    reference's serialized det -> rec -> compare loop, backend/main.py:
    255-376, as a tracker that frames of several videos can feed; results
    must arrive in order per video).

    A contiguous run of frames with text in the area is buffered and split
    into cue groups at flush time by ``split_text_groups`` (a mid-fade
    garble merges back into its cue); each group records its medoid read
    at its first and last frame. Absences shorter than the grace (0.2 s,
    at least 2 frames) do not end a run. Once a run holds ``_FLUSH_AFTER``
    samples, the groups before its last are emitted early."""

    _FLUSH_AFTER = 256

    def __init__(self, extractor: "SubtitleExtractor"):
        self.ex = extractor
        self.thr = extractor.config.threshold_text_similarity / 100.0
        self.buf: list = []  # [(frame_no, area_text, conf, dt_box, rec_res)]
        fps = float(getattr(extractor, "fps", 0.0) or 25.0)
        self.grace = max(2, round(0.2 * fps))

    def _emit(self, groups: list) -> None:
        for g in groups:
            # presence flips always split, so a group is all-empty or all-text;
            # an empty group records nothing
            if not g[0][1]:
                continue
            best = medoid_of(g)
            self.ex._gate_and_record(g[0][0], best[3], best[4])
            if g[-1][0] != g[0][0]:
                self.ex._gate_and_record(g[-1][0], best[3], best[4])

    def _flush(self) -> None:
        if self.buf:
            self._emit(split_text_groups(self.buf, self.thr))
            self.buf = []

    def feed(self, frame_no: int, dt_box: list, rec_res: list) -> None:
        with annotate("tracker.feed"):
            ex = self.ex
            if not any(ex.in_area(quad) for quad in dt_box):
                if self.buf and frame_no - self.buf[-1][0] >= self.grace:
                    self._flush()
                return
            area_text = ex._area_text(dt_box, rec_res)
            kept = ex._gate_lines(dt_box, rec_res)
            conf = float(np.mean([p for _, _, p in kept])) if kept else 0.0
            self.buf.append((frame_no, area_text, conf, dt_box, rec_res))
            if len(self.buf) >= self._FLUSH_AFTER:
                groups = split_text_groups(self.buf, self.thr)
                if len(groups) > 1:
                    # only the last group can still grow or merge back
                    self._emit(groups[:-1])
                    self.buf = list(groups[-1])

    def finish(self) -> None:
        with annotate("tracker.finish"):
            self._flush()


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
        self.device = resolve_device(device)
        self.video = video
        self.meta = probe(video)
        self.fps = self.meta.fps
        self.frame_count = self.meta.frame_count
        self.frame_height = self.meta.height
        self.frame_width = self.meta.width
        self.sub_area = sub_area
        self.confirm = confirm
        self.resume = resume
        self._engine = engine
        self.raw_records: List[RawRecord] = []
        self.timeline = SrtFile()
        self.use_keyframe_timeline = False
        self._frame_to_ms: Dict[int, float] = {}
        self.video_path = path = video_path(video)
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

    def append_output(self, *args) -> None:
        """Log hook; a service or GUI replaces this attribute (reference
        main.py:1045-1050)."""
        print(*args)

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
            xmin, xmax, ymin, ymax = quad_bounds(quad)
            if self.engine.family == "en":
                text = CJK_RE.sub("", text)
            if self.sub_area is not None:
                overflow = self.sub_area.overflow_area_rate(xmin, xmax, ymin, ymax)
                if overflow > dev_rate or prob <= drop_score:
                    continue
            kept.append(((int(xmin), int(xmax), int(ymin), int(ymax)), text, prob))
        return kept

    def _gate_and_record(self, frame_no: int, dt_box: list, rec_res: list,
                         frame: Optional[np.ndarray] = None,
                         ab_checked: bool = False) -> None:
        """Gate one frame's lines and append them as raw records; with an
        AB section, only frames inside it record (``ab_checked``: the
        caller applied that gate to the real frame number). With
        ``debug_ocr_loss``, ``frame`` is the image the loss debugger
        dumps."""
        if not ab_checked and not self._in_ab_section(frame_no):
            return
        kept_before = len(self.raw_records)
        for box, text, _prob in self._gate_lines(dt_box, rec_res):
            self.raw_records.append(RawRecord(frame_no, box, text))
        if self.config.debug_ocr_loss and frame is not None:
            self._maybe_dump_ocr_loss(frame, frame_no, self.raw_records[kept_before:])

    # characters of the CJK-family scripts the loss debugger watches
    _LOSS_RE = re.compile(r"[一-龥㐀-䶵㄰-㆏가-힣ࠀ-一]")

    def _maybe_dump_ocr_loss(self, frame: np.ndarray, frame_no: int, kept) -> None:
        """Write ``loss/<frame_no>.png`` beside the video, the frame with the
        area (blue) and the kept lines' boxes (red), when a ch,
        chinese_cht, japan or korean read kept text but lost every CJK
        character (reference backend/tools/subtitle_ocr.py:88-102)."""
        if self.engine.family not in ("ch", "chinese_cht", "japan", "korean"):
            return
        line = "".join(r.text for r in kept)
        if not line or self._LOSS_RE.search(line) is not None:
            return
        import cv2

        loss_dir = os.path.join(os.path.dirname(self.video_path), "loss")
        os.makedirs(loss_dir, exist_ok=True)
        img = frame[:, :, ::-1].copy()  # RGB -> BGR for cv2
        if self.sub_area is not None:
            a = self.sub_area
            cv2.rectangle(img, (a.xmin, a.ymin), (a.xmax, a.ymax), (255, 0, 0), 2)
        for r in kept:
            xmin, xmax, ymin, ymax = r.coord
            cv2.rectangle(img, (xmin, ymin), (xmax, ymax), (0, 0, 255), 2)
        cv2.imwrite(os.path.join(loss_dir, f"{str(frame_no).zfill(8)}.png"), img)

    def in_area(self, quad) -> bool:
        """Whether a box lies wholly inside the area (always, without one)."""
        return self.sub_area is None or self.sub_area.contains_box(*quad_bounds(quad))

    def _area_text(self, dt_box: list, rec_res: list) -> str:
        """The concatenated text of the boxes fully inside the area
        (reference backend/main.py:895-921 ``__get_area_text``)."""
        return "".join(text for quad, (text, _) in zip(dt_box, rec_res) if self.in_area(quad))

    def stream(self, batch_size: int, **kw) -> FrameStream:
        """A frame stream of the video on the configured decoder."""
        return FrameStream(self.video, batch_size=batch_size,
                           decoder=self.config.scanner_decoder, **kw)

    def capture_frame_with_subtitle_area(self, output_path: Optional[str] = None
                                         ) -> Optional[str]:
        """Save the first frame with the subtitle area drawn on it, as
        ``sub_area.jpg`` beside the SRT unless ``output_path`` is given
        (reference backend/main.py:193-226). Needs OpenCV."""
        import cv2

        frame = read_frames(self.video, [0])[0]
        if frame is None:
            return None
        frame = frame[:, :, ::-1].copy()  # RGB -> BGR for cv2
        if self.sub_area is not None:
            a = self.sub_area
            cv2.rectangle(frame, (a.xmin, a.ymin), (a.xmax, a.ymax), (0, 255, 0), 2)
            cv2.putText(frame, "Subtitle Area", (a.xmin, max(0, a.ymin - 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.9, (0, 255, 0), 2)
        if output_path is None:
            output_path = os.path.join(os.path.dirname(self.subtitle_output_path),
                                       "sub_area.jpg")
        cv2.imwrite(output_path, frame)
        return output_path

    def dump_raw_records(self, path: Optional[str] = None) -> str:
        """Write the raw records as ``raw.txt`` beside the SRT (or to
        ``path``) in the reference's line format (the reference keeps it
        with debugNoDeleteCache, backend/main.py:981-987)."""
        if path is None:
            path = os.path.join(os.path.dirname(self.subtitle_output_path), "raw.txt")
        write_raw(self.raw_records, path)
        return path

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
        (kernel K2 on the card), each frame cropped to the area by the
        stream's reader and each batch uploaded ahead by ``device_prefetch``;
        the stats stay on the device until the pass ends. Then the spans and
        the raw timeline."""
        a = self.sub_area
        stream = self.stream(32, region=(a.ymin, a.ymax, a.xmin, a.xmax))
        params = ScanParams()
        all_stats: List[torch.Tensor] = []
        all_nos: List[np.ndarray] = []
        for batch, band in device_prefetch(stream, self.device):
            self._check_cancel()
            n_valid = int(batch.valid.sum())
            with annotate("scan.k2", batch=len(all_stats)):
                all_stats.append(scan_stats_u8(band, params)[:n_valid])
            all_nos.append(batch.frame_nos[:n_valid])
            done = float(batch.frame_nos[n_valid - 1]) / max(1, self.frame_count)
            self.update_progress(frame_extract=done * 100)
        self._frame_to_ms.update(stream.frame_to_ms)
        if not all_stats:
            return []
        with annotate("scan.fetch"):
            stats = torch.cat(all_stats).cpu().numpy()
        with annotate("scan.find_spans"):
            spans = find_spans(stats, np.concatenate(all_nos), params)
        self.timeline = SrtFile()
        for i, sp in enumerate(spans):
            self.timeline.append(SrtItem(
                i + 1, int(self.frame_to_ms(sp.start_frame)),
                int(self.frame_to_ms(sp.end_frame)), "",
            ))
        self.use_keyframe_timeline = True
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
        [(span_idx, frame_no, dt_box, rec_res, frame)] in frame order per
        span, ``frame`` None unless the loss debugger keeps it.
        Rebuilds ``self.timeline``; textless groups keep their (empty)
        timeline cue but record nothing."""
        thr = self.config.threshold_text_similarity / 100.0
        by_span = defaultdict(list)
        for si, fn, dt_box, rec_res, frame in samples:
            kept = self._gate_lines(dt_box, rec_res)
            text = "".join(t.replace(" ", "") for _, t, _ in kept)
            conf = float(np.mean([p for _, _, p in kept])) if kept else 0.0
            by_span[si].append((fn, text, conf, dt_box, rec_res, frame))
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
                self._gate_and_record(self.ms_to_frameno(start_ms), best[3], best[4],
                                      frame=best[5], ab_checked=True)
        self.use_keyframe_timeline = True

    def extract_frame_by_keyframe(self) -> None:
        """Pass 1 scans; pass 2 OCRs the within-span samples (decoded in one
        pass) on the uploaded band and refines the spans by text change."""
        t0 = time.perf_counter()
        with annotate("pass.scan"):
            spans = self.scan_keyframe_spans()
        t1 = time.perf_counter()
        with annotate("pass.ocr"):
            wanted, metas = self.keyframe_sample_targets(spans)
            decoded = read_frames(self.video, wanted)
            pairs = [(m, f) for m, f in zip(metas, decoded) if f is not None]
            B = self.config.frame_batch
            y0, y1 = self.upload_band() or (0, self.frame_height)
            # the sampled frames are kept only for the loss debugger
            keep_frames = self.config.debug_ocr_loss
            samples = []
            for i in range(0, len(pairs), B):
                self._check_cancel()
                chunk = np.stack([f[y0:y1] for _, f in pairs[i : i + B]])
                results = self.engine.predict_batch(chunk, origin=(y0, 0))
                for (m, f), (dt_box, rec_res) in zip(pairs[i : i + B], results):
                    samples.append((m[0], m[1], dt_box, rec_res, f if keep_frames else None))
                self.update_progress(ocr=min(100.0, (i + B) / max(1, len(pairs)) * 100))
        t2 = time.perf_counter()
        self.refine_keyframe_spans(spans, samples)
        self.pass_seconds.update(scan=t1 - t0, ocr=t2 - t1)
        self.n_spans, self.n_samples = len(spans), len(pairs)

    # --- fps strategy ----------------------------------------------------------

    def extract_frame_by_fps(self) -> None:
        """OCR every ``fps // extract_frequency``-th frame (reference
        backend/main.py:228-253) in batches of ``frame_batch``, uploaded
        ahead by ``device_prefetch``: whole frames, since this strategy runs
        only without an area. With ``resume``, the progress manifest
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
                self.append_output(tr("ResumeFrom", start_frame, len(manifest.records)))
            else:
                manifest = ProgressManifest(path, "fps")
        stream = self.stream(self.config.frame_batch, stride=stride,
                             start_frame=start_frame)
        batches_since_save = n_samples = 0
        for batch, frames in device_prefetch(stream, self.device):
            self._check_cancel()
            n_valid = int(batch.valid.sum())
            results = self.engine.predict_batch(frames)[:n_valid]
            for i, (dt_box, rec_res) in enumerate(results):
                self._gate_and_record(int(batch.frame_nos[i]), dt_box, rec_res,
                                      frame=batch.frames[i])
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

    # --- per-frame detection (mode accurate with an area) -------------------

    def extract_frame_by_det(self) -> None:
        """Every frame's upload band through the engine in batches of
        ``frame_batch`` (reference backend/main.py:255-376, :924-952),
        cropped by the stream's reader and uploaded ahead by
        ``device_prefetch``; ``DetSpanTracker`` turns the per-frame reads
        into cues."""
        t0 = time.perf_counter()
        y0, y1 = self.upload_band() or (0, self.frame_height)
        stream = self.stream(self.config.frame_batch, region=(y0, y1, 0, self.frame_width))
        tracker = DetSpanTracker(self)
        n_frames = 0
        for batch, frames in device_prefetch(stream, self.device):
            self._check_cancel()
            n_valid = int(batch.valid.sum())
            results = self.engine.predict_batch(frames, origin=(y0, 0))[:n_valid]
            for i in range(n_valid):
                frame_no = int(batch.frame_nos[i])
                tracker.feed(frame_no, *results[i])
                done = frame_no / max(1, self.frame_count)
                self.update_progress(frame_extract=done * 100, ocr=done * 100)
            n_frames += n_valid
        tracker.finish()
        self._frame_to_ms.update(stream.frame_to_ms)
        self.pass_seconds["ocr"] = time.perf_counter() - t0
        self.n_samples = n_frames

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
        with tracing.clip(), annotate("extract", video=self.video_path):
            t0 = time.perf_counter()
            self.update_progress(0, 0)
            self.raw_records = []
            self.pass_seconds = {}
            self.n_spans = self.n_samples = 0
            if self.sub_area is not None and self.config.mode == Mode.ACCURATE:
                with annotate("pass.ocr"):
                    self.extract_frame_by_det()
            elif self.sub_area is not None:
                self.extract_frame_by_keyframe()
            else:
                with annotate("pass.ocr"):
                    self.extract_frame_by_fps()
            t1 = time.perf_counter()
            with annotate("pass.post"):
                if self.sub_area is None:
                    self.apply_filters()
                if self.config.debug_no_delete_cache:
                    self.dump_raw_records()
                self.generate_subtitle_file()
                if self.config.word_segmentation:
                    reformat_execute(self.subtitle_output_path, self.config.language)
                self.update_progress(100, 100)
                if self.config.generate_txt:
                    srt_to_txt(self.subtitle_output_path)
            self.pass_seconds["post"] = time.perf_counter() - t1
            self.pass_seconds["total"] = time.perf_counter() - t0
            self.append_output(tr("ExtractionDone", f"{self.pass_seconds['total']:.1f}",
                                  self.subtitle_output_path))
            self.append_output(tr("SubLocation", self.subtitle_output_path))
            return self.subtitle_output_path

    def generate_subtitle_file(self) -> None:
        """Dedup the raw records, then merge them into the keyframe timeline
        (keyframe strategy) or pad them into cues (fps and per-frame det)."""
        keyframe = self.use_keyframe_timeline
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

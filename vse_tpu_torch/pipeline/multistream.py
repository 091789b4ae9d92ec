"""Continuous multi-video batching (the port of
``vse_tpu/pipeline/multistream.py``).

The reference extracts a queue one video at a time. Here the samples of
several videos share fixed-size OCR chunks on one engine, and the results
go back to their videos:

- fps strategy (no area, or not every video has one): the sampled frames
  of all videos that share a geometry and an upload band interleave round
  robin into ``frame_batch``-sized batches (``interleave_streams``; the
  tail batch padded with black frames whose results are dropped), uploaded
  ahead by ``device_prefetch``;
- keyframe strategy (mode fast, every video with an area): the scan (kernel
  K2) runs per video; the within-span samples of all videos, each cropped to
  its own upload band, share the OCR chunks of their cropped shape, so one
  chunk and one K1 launch may hold samples of several videos; the tail
  chunk is padded to ``frame_batch``.

Then each video, on its own: the watermark and scene-text filters (no area),
dedup and its SRT, word segmentation. Only mode fast is ported: modes auto
and accurate need the server det weights (``det_server``), which the port
cannot read yet, and raise.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.pipeline.feed import device_prefetch
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.post.reformat import execute as reformat_execute
from vse_tpu_torch.video.decode import FrameStream, Video, probe, read_frames, video_path


@dataclass
class TaggedBatch:
    frames: np.ndarray  # [B, H, W, 3]
    video_ids: np.ndarray  # [B] int, -1 on padding
    frame_nos: np.ndarray  # [B]
    valid: np.ndarray  # [B] bool


def interleave_streams(
    streams: Sequence[FrameStream], batch_size: int,
    crop: Optional[Tuple[int, int]] = None,
) -> Iterator[TaggedBatch]:
    """Round-robin the valid frames of several streams into shared batches
    of ``batch_size``: each refill takes the next batch of every stream that
    is not exhausted, in stream order; the final partial batch is padded.
    The streams must share a frame geometry. ``crop=(y0, y1)`` keeps only
    those frame rows (the shared upload band)."""
    iters: List[Tuple[int, Iterator]] = [(i, iter(s)) for i, s in enumerate(streams)]
    pending: List[Tuple[int, np.ndarray, int]] = []
    shape = None

    def refill():
        nonlocal shape
        alive = []
        for vid, it in iters:
            try:
                b = next(it)
            except StopIteration:
                continue
            alive.append((vid, it))
            n = int(b.valid.sum())
            frames = b.frames if crop is None else b.frames[:, crop[0] : crop[1]]
            for k in range(n):
                pending.append((vid, frames[k], int(b.frame_nos[k])))
            if shape is None and n:
                shape = frames[0].shape
        iters[:] = alive

    while True:
        while iters and len(pending) < batch_size:
            refill()
        if not pending:
            return
        take = pending[:batch_size]
        del pending[:batch_size]
        frames = np.zeros((batch_size,) + tuple(shape), np.uint8)
        vids = np.full((batch_size,), -1, np.int64)
        nos = np.zeros((batch_size,), np.int64)
        valid = np.zeros((batch_size,), bool)
        for i, (vid, f, no) in enumerate(take):
            frames[i], vids[i], nos[i], valid[i] = f, vid, no, True
        yield TaggedBatch(frames, vids, nos, valid)


def extract_many(
    videos: Sequence[Video],
    sub_areas: Optional[Sequence] = None,
    config: Optional[VseConfig] = None,
    engine: Optional[OcrEngine] = None,
    output_paths: Optional[Sequence[str]] = None,
    device: Union[str, torch.device] = "cuda",
    stats: Optional[dict] = None,
) -> Dict[str, str]:
    """Extract several videos through shared OCR chunks on ONE engine.
    Returns {video path: SRT path}. ``stats``, when given, receives
    ``chunks`` (the OCR chunks run) and ``samples`` (OCR samples per
    video). Modes other than fast raise, as ``SubtitleExtractor`` does."""
    config = config or VseConfig()
    n = len(videos)
    sub_areas = list(sub_areas) if sub_areas is not None else [None] * n
    extractors = []
    for i, v in enumerate(videos):
        ex = SubtitleExtractor(v, sub_area=sub_areas[i], config=config, engine=engine,
                               device=device)
        if engine is None:
            engine = ex.engine  # one engine for the whole queue
        if output_paths is not None:
            ex.subtitle_output_path = output_paths[i]
        extractors.append(ex)

    if all(a is not None for a in sub_areas):
        chunks = _many_keyframe(extractors, engine, config)
    else:
        chunks = _many_fps(extractors, engine, config)
    if stats is not None:
        stats.update(chunks=chunks, samples=[ex.n_samples for ex in extractors])

    out = {}
    for ex in extractors:
        if ex.sub_area is None:
            ex.apply_filters()  # as SubtitleExtractor.run() filters
        ex.generate_subtitle_file()
        if config.word_segmentation:
            reformat_execute(ex.subtitle_output_path, config.language)
        ex.update_progress(100, 100)
        out[ex.video_path] = ex.subtitle_output_path
    return out


def _geometry_groups(extractors) -> Dict[Tuple, List[int]]:
    """Group by (H, W, upload band): only videos sharing a geometry and a
    band share batches."""
    groups: Dict[Tuple, List[int]] = defaultdict(list)
    for i, ex in enumerate(extractors):
        groups[(ex.frame_height, ex.frame_width, ex.upload_band())].append(i)
    return groups


def _many_fps(extractors, engine: OcrEngine, config: VseConfig) -> int:
    """The fps strategy over shared batches. Each batch goes to the engine
    whole (padding included, one batch shape); results of padded rows are
    dropped. Returns the number of batches."""
    n_batches = 0
    for (_h, _w, band), ids in _geometry_groups(extractors).items():
        origin = (band[0], 0) if band is not None else (0, 0)
        streams = []
        for i in ids:
            ex = extractors[i]
            stride = max(1, int(ex.fps // config.extract_frequency))
            streams.append(FrameStream(ex.video, batch_size=config.frame_batch, stride=stride))
        batches = interleave_streams(streams, config.frame_batch, crop=band)
        for batch, frames in device_prefetch(batches, engine.device):
            nv = int(batch.valid.sum())
            results = engine.predict_batch(frames, origin=origin)
            for k in range(nv):
                ex = extractors[ids[int(batch.video_ids[k])]]
                ex._gate_and_record(int(batch.frame_nos[k]), *results[k])
                ex.n_samples += 1
            n_batches += 1
        for i, s in zip(ids, streams):
            extractors[i]._frame_to_ms.update(s.frame_to_ms)
    return n_batches


def _shift_quads(dt_box: list, dy: int) -> list:
    return [[(x, y + dy) for (x, y) in quad] for quad in dt_box]


def _many_keyframe(extractors, engine: OcrEngine, config: VseConfig) -> int:
    """Pass 1 per video (the scan); pass 2 pooled across videos, each sample
    cropped to its video's upload band, boxes shifted back by the band's
    offset, chunks grouped by cropped shape and the tail chunk padded;
    pass 3 per video (``refine_keyframe_spans``). Returns the number of
    chunks."""
    todo = []  # (extractor index, band-cropped frame, dy, span index, frame_no)
    spans_by_ex: Dict[int, list] = {}
    for xi, ex in enumerate(extractors):
        spans = ex.scan_keyframe_spans()
        spans_by_ex[xi] = spans
        ex.n_spans = len(spans)
        wanted, metas = ex.keyframe_sample_targets(spans)
        band = ex.upload_band()
        y0 = band[0] if band is not None else 0
        for f, (si, fn) in zip(read_frames(ex.video, wanted), metas):
            if f is not None:
                todo.append((xi, f if band is None else f[band[0] : band[1]], y0, si, fn))
                ex.n_samples += 1
    by_shape: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for idx, item in enumerate(todo):
        by_shape[item[1].shape[:2]].append(idx)
    B = config.frame_batch
    samples_by_ex: Dict[int, list] = defaultdict(list)
    n_chunks = 0
    for idxs in by_shape.values():
        for i in range(0, len(idxs), B):
            chunk_ids = idxs[i : i + B]
            chunk = np.zeros((B,) + todo[chunk_ids[0]][1].shape, np.uint8)
            for r, j in enumerate(chunk_ids):
                chunk[r] = todo[j][1]
            results = engine.predict_batch(chunk)
            for j, (dt_box, rec_res) in zip(chunk_ids, results):
                xi, _f, dy, si, fn = todo[j]
                samples_by_ex[xi].append((si, fn, _shift_quads(dt_box, dy), rec_res, None))
            n_chunks += 1
    for xi, ex in enumerate(extractors):
        samples = sorted(samples_by_ex.get(xi, []), key=lambda s: (s[0], s[1]))
        ex.refine_keyframe_spans(spans_by_ex[xi], samples)
    return n_chunks


def extract_many_fps(
    videos: Sequence[Video],
    engine: OcrEngine,
    config: Optional[VseConfig] = None,
    on_result=None,
) -> Dict[str, List[Tuple[int, list, list]]]:
    """OCR several videos' fps samples through shared batches, with no
    filters and no SRT. Returns {video path: [(frame_no, dt_box, rec_res),
    ...]} sorted by frame; ``on_result(video_index, frame_no, dt_box,
    rec_res)`` streams results as they land."""
    config = config or VseConfig()
    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    metas = [probe(v) for v in videos]
    for i, m in enumerate(metas):
        groups[(m.height, m.width)].append(i)
    paths = [video_path(v) for v in videos]
    out: Dict[str, List] = {p: [] for p in paths}
    for vid_ids in groups.values():
        streams = [FrameStream(videos[v], batch_size=config.frame_batch,
                               stride=max(1, int(metas[v].fps // config.extract_frequency)))
                   for v in vid_ids]
        batches = interleave_streams(streams, config.frame_batch)
        for batch, frames in device_prefetch(batches, engine.device):
            results = engine.predict_batch(frames)
            for i in range(int(batch.valid.sum())):
                vid = vid_ids[int(batch.video_ids[i])]
                dt_box, rec_res = results[i]
                out[paths[vid]].append((int(batch.frame_nos[i]), dt_box, rec_res))
                if on_result:
                    on_result(vid, int(batch.frame_nos[i]), dt_box, rec_res)
    for records in out.values():
        records.sort(key=lambda r: r[0])
    return out

"""A whole run of each cell on the CPU at a tiny size: the port
(``device="cpu"``, its plain kernels) on 4 s clips (2 s for the per-frame
cell, whose server det reads every frame), judged against the plain
reference with the cell's own limits; and the same run with the timed path broken underneath, once for each fault the cell can have,
judged not correct: the scan's state left unchanged (every batch gets the
first batch's stats; keyframe cells), half of each OCR batch left out
(only its first half is read; the per-frame path raises on the missing
results, so the run stops with no result), the det finding boxes in the
first half of each OCR chunk only (the rest of the frames come back
empty), and every read altered where the OCR step produces it."""

import json

import numpy as np
import pytest

from _helpers import tiny_traffic

import run

SEED = 2 ** 31 + 3


CELLS = {"mobile-ch.keyframe-area": ("keyframe-area", 4),
         "server-ch.perframe-area": ("perframe-area", 2)}


def _run(tmp_path, capsys, cell):
    name, seconds = CELLS[cell]
    tf = tiny_traffic(tmp_path, name, clip_seconds=seconds)
    with open(tf, "r", encoding="utf-8") as f:
        traffic = json.load(f)
    from gen import subtitle_clips as gen
    assert gen.plan_pool(traffic, SEED)[1]["cues"], "the clip must hold a cue"
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.1",
                   "--trace", "0", "--device", "cpu", "--traffic-file", tf,
                   "--cache", str(tmp_path / "pool"), "--pool-workers", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if rc == 0 else None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_on_the_cpu_is_correct(tmp_path, capsys, cell):
    rc, res = _run(tmp_path, capsys, cell)
    assert rc == 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"


def _altered_read(orig):
    def f(self, frames):
        boxes, det, valid, ids, mask, rec = orig(self, frames)
        return boxes, det, valid, np.where(mask, ids % 21059 + 1, ids), mask, rec
    return f


def _det_half_empty(orig):
    def f(self, frames):  # boxes in the first half of each chunk only
        boxes, det, valid, ids, mask, rec = orig(self, frames)
        keep = len(valid) // 2
        valid, mask = valid.copy(), mask.copy()
        valid[keep:], mask[keep:] = False, False
        return boxes, det, valid, ids, mask, rec
    return f


def _half_left_out(orig):
    def f(self, frames, *a, **kw):  # only the first half of each batch is read
        return orig(self, frames[: (len(frames) + 1) // 2], *a, **kw)
    return f


def _stale_scan(orig):
    state = {}

    def f(band, *a, **kw):
        out = orig(band, *a, **kw)
        first = state.setdefault("first", out.clone())
        return first[: len(out)] if len(first) >= len(out) else out
    return f


# (fault, the number that catches it, or None where the run stops with no result)
FAULTS = {"mobile-ch.keyframe-area": [("altered_read", "read_nll_gap_mean"),
                                      ("half_left_out", "frames_unread"),
                                      ("det_half_empty", "box_px_p75"),
                                      ("stale_scan", "scan_stat_gap")],
          "server-ch.perframe-area": [("altered_read", "read_nll_gap_mean"),
                                      ("half_left_out", None),
                                      ("det_half_empty", "box_px_p75")]}


@pytest.mark.parametrize("cell, fault, number",
                         [(c, f, n) for c in sorted(CELLS) for f, n in FAULTS[c]])
def test_broken_path_is_not_correct(tmp_path, capsys, monkeypatch, cell, fault, number):
    from vse_tpu_torch.pipeline import extractor, ocr_engine

    if fault == "stale_scan":
        monkeypatch.setattr(extractor, "scan_stats_u8", _stale_scan(extractor.scan_stats_u8))
    elif fault == "half_left_out":
        monkeypatch.setattr(ocr_engine.OcrEngine, "predict_batch",
                            _half_left_out(ocr_engine.OcrEngine.predict_batch))
    else:
        wrap = _altered_read if fault == "altered_read" else _det_half_empty
        monkeypatch.setattr(ocr_engine.OcrEngine, "ocr_arrays",
                            wrap(ocr_engine.OcrEngine.ocr_arrays))
    rc, res = _run(tmp_path, capsys, cell)
    if number is None:
        assert rc != 0 and res is None
        return
    assert rc == 0 and res["correct"] is False
    check = res["checks"][number]
    assert check["value"] > check["limit"]

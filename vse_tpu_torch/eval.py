"""Subtitle quality metrics: line-level F1 + CER vs a reference SRT (the
port of ``vse_tpu/eval.py``, host code whose every float equals the JAX
package's).

BASELINE.json gates quality on "subtitle-line F1 + CER vs reference SRT"
(target F1 >= 0.99). Definitions:

- cues pair greedily by time-IoU (best overlap first, IoU > `iou_thresh`);
- a pair is a true positive when the normalized texts' indel similarity
  >= `sim_thresh`;
- precision = TP / #pred, recall = TP / #ref, F1 = harmonic mean;
- CER = total edit distance over paired texts / total reference length,
  with unmatched reference cues counted as fully deleted.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import List, Tuple

from vse_tpu_torch.ops.levenshtein import ratio
from vse_tpu_torch.post.srt import SrtFile


def normalize_text(t: str) -> str:
    t = unicodedata.normalize("NFKC", t)
    t = re.sub(r"\s+", " ", t)
    return t.strip().lower()


def _edit_distance(a: str, b: str) -> int:
    """Plain Levenshtein (substitution cost 1) for CER."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ca = a[i - 1]
        for j in range(1, lb + 1):
            cost = 0 if ca == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[lb]


def time_iou(a_start, a_end, b_start, b_end) -> float:
    inter = min(a_end, b_end) - max(a_start, b_start)
    if inter <= 0:
        return 0.0
    union = max(a_end, b_end) - min(a_start, b_start)
    return inter / union if union > 0 else 0.0


@dataclass
class EvalResult:
    precision: float
    recall: float
    f1: float
    cer: float
    matched: int
    n_ref: int
    n_pred: int
    # raw CER numerator/denominator, kept so multi-video corpora can
    # micro-average (sum) instead of averaging per-video ratios
    edit_dist: int = 0
    ref_chars: int = 0

    def as_dict(self):
        return {
            "precision": round(self.precision, 4),
            "recall": round(self.recall, 4),
            "f1": round(self.f1, 4),
            "cer": round(self.cer, 4),
            "matched": self.matched,
            "n_ref": self.n_ref,
            "n_pred": self.n_pred,
        }


def evaluate_srt(
    pred: SrtFile,
    ref: SrtFile,
    iou_thresh: float = 0.3,
    sim_thresh: float = 0.8,
) -> EvalResult:
    preds = [(p.start_ms, p.end_ms, normalize_text(p.text)) for p in pred]
    refs = [(r.start_ms, r.end_ms, normalize_text(r.text)) for r in ref]
    # greedy best-overlap pairing
    candidates: List[Tuple[float, int, int]] = []
    for i, r in enumerate(refs):
        for j, p in enumerate(preds):
            iou = time_iou(r[0], r[1], p[0], p[1])
            if iou > iou_thresh:
                candidates.append((iou, i, j))
    candidates.sort(reverse=True)
    used_ref, used_pred = set(), set()
    pairs: List[Tuple[int, int]] = []
    for iou, i, j in candidates:
        if i in used_ref or j in used_pred:
            continue
        used_ref.add(i)
        used_pred.add(j)
        pairs.append((i, j))
    tp = sum(1 for i, j in pairs if ratio(refs[i][2], preds[j][2]) >= sim_thresh)
    precision = tp / len(preds) if preds else (1.0 if not refs else 0.0)
    recall = tp / len(refs) if refs else 1.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    # CER over paired + unmatched-ref-as-deletions
    dist = 0
    total = 0
    for i, j in pairs:
        dist += _edit_distance(refs[i][2], preds[j][2])
        total += len(refs[i][2])
    for i, r in enumerate(refs):
        if i not in used_ref:
            dist += len(r[2])
            total += len(r[2])
    cer = dist / total if total else 0.0
    return EvalResult(precision, recall, f1, cer, tp, len(refs), len(preds),
                      edit_dist=dist, ref_chars=total)


def evaluate_files(pred_path: str, ref_path: str, **kw) -> EvalResult:
    return evaluate_srt(SrtFile.open(pred_path), SrtFile.open(ref_path), **kw)


def micro_average(results: List[EvalResult]) -> EvalResult:
    """Pool cue counts and CER numerators across videos (corpus-level
    metrics; per-video ratios would over-weight short videos)."""
    tp = sum(r.matched for r in results)
    n_ref = sum(r.n_ref for r in results)
    n_pred = sum(r.n_pred for r in results)
    dist = sum(r.edit_dist for r in results)
    total = sum(r.ref_chars for r in results)
    precision = tp / n_pred if n_pred else (1.0 if not n_ref else 0.0)
    recall = tp / n_ref if n_ref else 1.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    cer = dist / total if total else 0.0
    return EvalResult(precision, recall, f1, cer, tp, n_ref, n_pred,
                      edit_dist=dist, ref_chars=total)

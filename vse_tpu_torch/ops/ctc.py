"""Prefix beam search for CTC on the host (the port of
``vse_tpu/ops/ctc.py::ctc_prefix_beam_decode``, a copy of its numpy code),
and ``decode_batch_to_texts``, which turns a greedy decode into strings.

The engine's ``decode="beam"`` option runs it over log-probs that the rec
forward computes on the device (``OcrEngine._predict_batch_beam``); the
greedy decode is kernel K1 (``kernels/ctc_decode.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def ctc_prefix_beam_decode(
    log_probs: np.ndarray, beam_width: int = 8, blank: int = 0, top_k: int = 16
) -> Tuple[List[int], float]:
    """Prefix beam search over one sequence of log-probs [T, C] (host side).

    Returns (ids, score) where score is exp(mean per-char log prob)."""
    T, C = log_probs.shape
    # beams: prefix tuple -> (log_p_blank, log_p_nonblank)
    NEG = -1e30

    def logsumexp2(a, b):
        m = max(a, b)
        if m <= NEG:
            return NEG
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    beams = {(): (0.0, NEG)}
    for t in range(T):
        lp = log_probs[t]
        cand = np.argsort(lp)[-top_k:]
        new_beams: dict = {}

        def add(prefix, pb, pnb):
            if prefix in new_beams:
                opb, opnb = new_beams[prefix]
                new_beams[prefix] = (logsumexp2(opb, pb), logsumexp2(opnb, pnb))
            else:
                new_beams[prefix] = (pb, pnb)

        for prefix, (pb, pnb) in beams.items():
            ptot = logsumexp2(pb, pnb)
            for c in cand:
                p = float(lp[c])
                if c == blank:
                    add(prefix, ptot + p, NEG)
                elif prefix and c == prefix[-1]:
                    # a repeat extends the same prefix; after a blank it is
                    # a new character
                    add(prefix, NEG, pnb + p)
                    add(prefix + (c,), NEG, pb + p)
                else:
                    add(prefix + (c,), NEG, ptot + p)
        scored = sorted(
            new_beams.items(),
            key=lambda kv: -logsumexp2(kv[1][0], kv[1][1]),
        )[:beam_width]
        beams = dict(scored)
    best_prefix, (pb, pnb) = max(
        beams.items(), key=lambda kv: logsumexp2(kv[1][0], kv[1][1])
    )
    total = logsumexp2(pb, pnb)
    n = max(1, len(best_prefix))
    return list(best_prefix), float(np.exp(total / n))


def decode_batch_to_texts(ids, mask, charset) -> List[str]:
    """Host-side: greedy decode output (ids, mask as arrays) -> strings."""
    ids = np.asarray(ids)
    mask = np.asarray(mask)
    return [charset.decode_ids([int(i) for i, m in zip(row_ids, row_mask) if m])
            for row_ids, row_mask in zip(ids, mask)]

"""A kernel's share of its memory roofline from the profiled clip."""

from __future__ import annotations

from collections import Counter

import devtrace
import yardstick


def share(r: dict, span: str, kernel_re: str, nbytes) -> float:
    """Bytes of the launches of ``span`` whose device records all arrived,
    over their device seconds and the HBM peak, in percent; None when no
    launch qualifies. A launch of a given shape is expected to have the
    number of records that most launches of that shape have."""
    shapes = {uid: sh for name, _, _, _, sh, uid in r["spans"] if name == span}
    per = devtrace.launches_with_records(r["profile"], span, kernel_re)
    if not per:
        return None
    usual = {}
    for sh, n in Counter((shapes.get(uid), k) for uid, (_, k) in per.items()).items():
        if n > usual.get(sh[0], (0, 0))[1]:
            usual[sh[0]] = (sh[1], n)
    ok = {uid: s for uid, (s, k) in per.items()
          if uid in shapes and k == usual[shapes[uid]][0]}
    seconds = sum(ok.values())
    if not ok or seconds <= 0:
        return None
    total = sum(nbytes(shapes[uid]) for uid in ok)
    return 100.0 * total / seconds / yardstick.PEAK_HBM_BYTES

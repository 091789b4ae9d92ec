"""Levenshtein similarity ratio, pure Python (the port keeps no native
library of its own yet).

The reference's dedup and span logic keys on ``Levenshtein.ratio``
(reference backend/main.py:798, :949): the normalized indel similarity
``(len(a) + len(b) - D) / (len(a) + len(b))``, where D is the edit distance
with substitution cost 2. It agrees exactly with
``vse_tpu.ops.levenshtein.ratio`` (its native, wheel and pure paths agree).

Results are memoized: accurate mode's span tracker compares every read of a
cue with every other (``medoid_of``), and a cue's frames repeat a handful of
texts, so a 500-frame pass asks ~42,000 ratios of a few dozen pairs.
"""

from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=1 << 16)
def ratio(a: str, b: str) -> float:
    """Normalized indel similarity in [0, 1]."""
    la, lb = len(a), len(b)
    lensum = la + lb
    if lensum == 0:
        return 1.0
    if la == 0 or lb == 0:
        return 0.0
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ca = a[i - 1]
        for j in range(1, lb + 1):
            if ca == b[j - 1]:
                cur[j] = prev[j - 1]
            else:
                cur[j] = 1 + min(prev[j], cur[j - 1])
        prev = cur
    return (lensum - prev[lb]) / lensum

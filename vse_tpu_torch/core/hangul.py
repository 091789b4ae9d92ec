"""Hangul syllable arithmetic, the decode side (the port of the jamo tables
and composition functions of ``vse_tpu/core/hangul.py``; its stroke
renderer is for training data and is not needed here).

Every modern syllable U+AC00..D7A3 decomposes into (initial, medial, final)
jamo by arithmetic; ``core/charset.py::JamoCharset`` decodes a korean head's
positional-jamo classes back into syllables with ``compose``.
"""

from __future__ import annotations

from typing import Tuple

S_BASE = 0xAC00
N_INITIAL, N_MEDIAL, N_FINAL = 19, 21, 28

INITIALS = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
MEDIALS = "ㅏㅐㅑㅒㅓㅔㅕㅖㅗㅘㅙㅚㅛㅜㅝㅞㅟㅠㅡㅢㅣ"
FINALS = "\0ㄱㄲㄳㄴㄵㄶㄷㄹㄺㄻㄼㄽㄾㄿㅀㅁㅂㅄㅅㅆㅇㅈㅊㅋㅌㅍㅎ"


def is_syllable(ch: str) -> bool:
    return S_BASE <= ord(ch) < S_BASE + N_INITIAL * N_MEDIAL * N_FINAL


def decompose(ch: str) -> Tuple[str, str, str]:
    """Syllable -> (initial, medial, final); final is '' when absent."""
    l, v, t = decompose_indices(ch)
    return INITIALS[l], MEDIALS[v], (FINALS[t] if t else "")


def decompose_indices(ch: str) -> Tuple[int, int, int]:
    """Syllable -> (initial, medial, final) indices; final 0 = none."""
    idx = ord(ch) - S_BASE
    l, rem = divmod(idx, N_MEDIAL * N_FINAL)
    v, t = divmod(rem, N_FINAL)
    return l, v, t


def compose(l: int, v: int, t: int = 0) -> str:
    """(initial, medial, final) indices -> the composed syllable."""
    return chr(S_BASE + (l * N_MEDIAL + v) * N_FINAL + t)

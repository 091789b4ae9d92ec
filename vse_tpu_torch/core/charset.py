"""Character sets of the rec heads (the parts of the JAX package's charset
module that the ported families need).

A language maps onto a script family (``script_family``), and the family
names the rec head and its character set. ``en`` is built in; the dict
families read a one-character-per-line file (the PaddleOCR format) from the
port's own copy under ``vse_tpu_torch/assets/dicts/<family>.txt``. Every
family of the JAX package's registry is ported but japan and chinese_cht,
which raise until their heads and dict files are ported (the JAX package
would fall back to the en charset for a family with no dict file; no
language of its ``LANGUAGES`` reaches that fallback, and the port raises
instead).

CTC convention: index 0 is the blank; characters are 1..N. A trailing space
character is appended when ``use_space_char`` (PaddleOCR-compatible). A rec
head's ``vse_meta.json`` says which variant its classes were trained on
(``fold_case``, ``use_space_char``, ``jamo``, ``homoglyph_fold``);
``OcrEngine`` applies them (``head_charset``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from vse_tpu_torch.core.hangul import FINALS, INITIALS, MEDIALS, compose, is_syllable

# Deterministic ASCII charset (printable ASCII minus control chars).
EN_CHARS = (
    "0123456789"
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)

# Language -> script family (reference backend/tools/paddle_model_config.py:25-45)
LATIN_LANGS = (
    "af", "az", "bs", "cs", "cy", "da", "de", "es", "et", "fr", "ga", "hr",
    "hu", "id", "is", "it", "ku", "la", "lt", "lv", "mi", "ms", "mt", "nl",
    "no", "oc", "pi", "pl", "pt", "ro", "rs_latin", "sk", "sl", "sq", "sv",
    "sw", "tl", "tr", "uz", "vi", "french", "german",
)
ARABIC_LANGS = ("ar", "fa", "ug", "ur")
CYRILLIC_LANGS = (
    "ru", "rs_cyrillic", "be", "bg", "uk", "mn", "abq", "ady", "kbd", "ava",
    "dar", "inh", "che", "lbe", "lez", "tab",
)
DEVANAGARI_LANGS = (
    "hi", "mr", "ne", "bh", "mai", "ang", "bho", "mah", "sck", "new", "gom",
    "sa", "bgc",
)

DICT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "dicts"
)
# families whose head, dict file and decode passes are ported
PORTED_DICT_FAMILIES = (
    "ch", "latin", "cyrillic", "devanagari", "arabic", "korean", "el", "ta",
    "te", "ka", "th",
)
# every ported family: en's charset is built in
PORTED_FAMILIES = ("en",) + PORTED_DICT_FAMILIES


def script_family(language: str) -> str:
    """Map a language code to its rec-head script family (reference
    paddle_model_config.py:84-91)."""
    if language in LATIN_LANGS:
        return "latin"
    if language in ARABIC_LANGS:
        return "arabic"
    if language in CYRILLIC_LANGS:
        return "cyrillic"
    if language in DEVANAGARI_LANGS:
        return "devanagari"
    return language  # ch, en, korean, japan, chinese_cht, ta, te, ka, th, el


@dataclass(frozen=True)
class Charset:
    """Immutable charset with the CTC blank at index 0.

    ``aliases`` records the (variant, canonical) pairs folded out of the
    classes by ``aliased``; decoding never emits a variant."""

    name: str
    chars: Tuple[str, ...]
    use_space_char: bool = True
    aliases: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.use_space_char and " " not in self.chars:
            object.__setattr__(self, "chars", tuple(self.chars) + (" ",))

    @property
    def vocab_size(self) -> int:
        return len(self.chars)

    def decode_ids(self, ids: Sequence[int]) -> str:
        """Non-blank, already-deduped ids -> text."""
        return "".join(
            self.chars[i - 1] for i in ids if 1 <= i <= len(self.chars)
        )

    def without_space(self) -> "Charset":
        """Space-class-free variant."""
        return Charset(self.name, tuple(c for c in self.chars if c != " "), False,
                       self.aliases)

    def aliased(self, alias_map: Dict[str, str]) -> "Charset":
        """Homoglyph-folded variant: each alias key loses its class (its
        canonical value keeps one)."""
        return Charset(
            self.name, tuple(c for c in self.chars if c not in alias_map),
            self.use_space_char, tuple(sorted(alias_map.items())),
        )

    def folded(self) -> "Charset":
        """Case-folded variant: lowercase letters only (the head reads
        either case as one class)."""
        seen: List[str] = []
        for c in self.chars:
            if c.lower() not in seen:
                seen.append(c.lower())
        return Charset(self.name, tuple(seen), self.use_space_char)

    @classmethod
    def from_file(cls, name: str, path: str, use_space_char: bool = True) -> "Charset":
        """Load a one-character-per-line dict file (PaddleOCR format): every
        non-empty line once ``\\n`` / ``\\r`` are stripped, so a line that
        holds one space stays."""
        chars = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n").rstrip("\r")
                if line:
                    chars.append(line)
        return cls(name=name, chars=tuple(chars), use_space_char=use_space_char)


# Conjoining-jamo token blocks (Unicode choseong/jungseong/jongseong): each
# positional jamo is its own CTC class, so initial-ㄱ and final-ㄱ differ and
# syllables recompose unambiguously at decode time.
_CHOSEONG = tuple(chr(0x1100 + i) for i in range(19))
_JUNGSEONG = tuple(chr(0x1161 + i) for i in range(21))
_JONGSEONG = tuple(chr(0x11A8 + i) for i in range(27))  # index 1..27 of FINALS


@dataclass(frozen=True)
class JamoCharset(Charset):
    """A korean charset factored into positional-jamo classes: 19 initials,
    21 medials and 27 finals beside the non-Hangul characters. Decoding
    recomposes each (initial, medial[, final]) run into its syllable; a
    lone jamo decodes to its compatibility form (ㅋㅋㅋ)."""

    def decode_ids(self, ids: Sequence[int]) -> str:
        toks = [self.chars[i - 1] for i in ids if 1 <= i <= len(self.chars)]
        out: List[str] = []
        i, n = 0, len(toks)
        while i < n:
            o = ord(toks[i])
            if 0x1100 <= o <= 0x1112:  # choseong
                if i + 1 < n and 0x1161 <= ord(toks[i + 1]) <= 0x1175:
                    l, v = o - 0x1100, ord(toks[i + 1]) - 0x1161
                    i += 2
                    t = 0
                    if i < n and 0x11A8 <= ord(toks[i]) <= 0x11C2:
                        t = ord(toks[i]) - 0x11A7
                        i += 1
                    out.append(compose(l, v, t))
                else:  # lone consonant -> compatibility form
                    out.append(INITIALS[o - 0x1100])
                    i += 1
            elif 0x1161 <= o <= 0x1175:  # stray vowel
                out.append(MEDIALS[o - 0x1161])
                i += 1
            elif 0x11A8 <= o <= 0x11C2:  # stray final
                out.append(FINALS[o - 0x11A7])
                i += 1
            else:
                out.append(toks[i])
                i += 1
        return "".join(out)


def to_jamo(base: Charset) -> JamoCharset:
    """Factor a syllable-level korean charset into the jamo charset: the
    non-Hangul characters keep their classes; syllables and compatibility
    jamo give way to the 67 positional jamo classes."""
    keep = tuple(
        c for c in base.chars
        if c != " " and not is_syllable(c) and not 0x3130 <= ord(c) < 0x3190
    )
    return JamoCharset(base.name, keep + _CHOSEONG + _JUNGSEONG + _JONGSEONG,
                       base.use_space_char)


_LOADED: Dict[str, Charset] = {}


def get_charset(language: str) -> Charset:
    """The charset of a language's script family: ``en`` built in, the
    ported dict families from ``DICT_DIR``."""
    family = script_family(language)
    if family in _LOADED:
        return _LOADED[family]
    if family == "en":
        cs = Charset(name="en", chars=tuple(EN_CHARS))
    elif family in PORTED_DICT_FAMILIES:
        cs = Charset.from_file(family, os.path.join(DICT_DIR, f"{family}.txt"))
    else:
        raise NotImplementedError(
            f"script family {family!r} (language {language!r}) is not ported "
            f"yet; this slice of the port supports "
            f"{', '.join(repr(f) for f in PORTED_FAMILIES)}"
        )
    _LOADED[family] = cs
    return cs

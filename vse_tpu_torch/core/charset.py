"""The ``en`` character set (the parts of the JAX package's charset module
that the en rec head needs).

CTC convention: index 0 is the blank; characters are 1..N. A trailing space
character is appended when ``use_space_char`` (PaddleOCR-compatible). A rec
head's ``vse_meta.json`` says which variant its classes were trained on
(``fold_case``, ``use_space_char``); ``OcrEngine`` applies them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

# Deterministic ASCII charset (printable ASCII minus control chars).
EN_CHARS = (
    "0123456789"
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)


@dataclass(frozen=True)
class Charset:
    """Immutable charset with the CTC blank at index 0."""

    name: str
    chars: Tuple[str, ...]
    use_space_char: bool = True

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
        return Charset(self.name, tuple(c for c in self.chars if c != " "), False)

    def folded(self) -> "Charset":
        """Case-folded variant: lowercase letters only (the head reads
        either case as one class)."""
        seen: List[str] = []
        for c in self.chars:
            if c.lower() not in seen:
                seen.append(c.lower())
        return Charset(self.name, tuple(seen), self.use_space_char)


def get_charset(language: str) -> Charset:
    """The charset of a language. This slice ports ``en`` only; other
    families need their dict files and decode passes, which later slices
    bring."""
    if language != "en":
        raise NotImplementedError(
            f"language {language!r} is not ported yet; this slice of the "
            "port supports 'en'"
        )
    return Charset(name="en", chars=tuple(EN_CHARS))

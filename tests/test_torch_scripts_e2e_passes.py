"""The keyframe strategy end to end against the JAX package, on the CPU,
for the two families whose heads need a charset pass: korean (positional
jamo classes, recomposed into syllables) and arabic (homoglyph-folded
classes, decoded in visual order and reversed to logical order, digit runs
kept). Each through the port's extractor: the SRT and every keyframe
sample's OCR lines must equal the JAX package's
(``tests/_torch_helpers.py::script_family_keyframe``). Their CLI runs are in
``tests/test_torch_scripts_cli.py``."""

import pytest

pytest.importorskip("cv2")

from _torch_helpers import script_family_keyframe, two_threads  # noqa: F401


@pytest.mark.parametrize("family", ["korean", "arabic"])
def test_keyframe_srt_and_lines_equal_jax(family, tmp_path):
    ex = script_family_keyframe(family, tmp_path)
    assert type(ex.engine.charset).__name__ == ("JamoCharset" if family == "korean"
                                                 else "Charset")

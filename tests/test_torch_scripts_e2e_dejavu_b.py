"""The keyframe strategy end to end against the JAX package, on the CPU,
for two of the families whose heads were trained on DejaVu Sans: el (with
the case fold and the homoglyph fold) and ka (latin and cyrillic are in
``tests/test_torch_scripts_e2e_dejavu.py``). Each family's
20 s clip of three cues (``assets/smoke/recipe_scripts.json``) goes through
the port's extractor with the default config for its language; the SRT and
every keyframe sample's OCR lines must equal the JAX package's
(``tests/_torch_helpers.py::script_family_keyframe``)."""

import pytest

pytest.importorskip("cv2")

from _torch_helpers import script_family_keyframe, two_threads  # noqa: F401


@pytest.mark.parametrize("family", ["el", "ka"])
def test_keyframe_srt_and_lines_equal_jax(family, tmp_path):
    script_family_keyframe(family, tmp_path)

"""The port's CLI for two languages of the non-CJK families, against the
JAX package's CLI, on the CPU: ``extract CLIP --area A --language ar`` and
``--language korean`` with the default config (word segmentation on), on
the families' keyframe clips written losslessly as FFV1; each SRT must be
byte-identical to the JAX CLI's (``reference_scripts.json``)."""

import pytest

pytest.importorskip("cv2")

from _torch_helpers import script_family_cli, two_threads  # noqa: F401


@pytest.mark.parametrize("family", ["korean", "arabic"])
def test_cli_runs_the_language(family, tmp_path):
    script_family_cli(family, tmp_path)

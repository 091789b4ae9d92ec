"""The port's main path end to end against the JAX package, on the CPU.

A short 1280x720 clip made from the committed smoke fixture (two cues with
a gap) is written losslessly (FFV1) and extracted by both packages with an
area in fast mode for ``en``: the SRTs must be byte-identical, through the
port's path input, its in-memory input and its CLI. Also: the port's OCR
engine reads the same texts as the JAX engine, the port imports neither
JAX nor vse_tpu, and its entry points refuse to run without CUDA unless
asked for the CPU.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
from vse_tpu.pipeline.extractor import SubtitleExtractor as JaxExtractor
from vse_tpu_torch import cli
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.video.decode import InMemoryVideo
from vse_tpu_torch.video.synth import compose_frames, load_fixture, recipe_area

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """84 frames (3.4 s at 25 fps): two cues of 32 frames, so each yields 4
    OCR samples and the 8 samples fill one OCR batch."""
    bands, recipe = load_fixture()
    recipe = dict(recipe, n_frames=84, cues=[
        dict(recipe["cues"][0], first=6, last=37),
        dict(recipe["cues"][1], first=46, last=77),
    ])
    frames = compose_frames(bands, recipe)
    d = tmp_path_factory.mktemp("clip")
    path = str(d / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 720))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    return path, frames, recipe


@pytest.fixture(scope="module")
def jax_run(clip):
    path, _, recipe = clip
    ex = JaxExtractor(path, JaxArea(*recipe["area"]),
                      JaxConfig(language="en", word_segmentation=False))
    with open(ex.run(), encoding="utf-8") as f:
        return f.read(), ex.engine


@pytest.fixture(scope="module")
def engine():
    return OcrEngine(language="en", config=VseConfig(word_segmentation=False), device="cpu")


def port_srt(video, recipe, engine, out_dir):
    ex = SubtitleExtractor(video, recipe_area(recipe), VseConfig(language="en", word_segmentation=False),
                           engine=engine, device="cpu")
    ex.subtitle_output_path = os.path.join(out_dir, "port.srt")
    with open(ex.run(), encoding="utf-8") as f:
        return f.read()


def test_srt_byte_identical_to_jax(clip, jax_run, engine, tmp_path):
    path, frames, recipe = clip
    ref, _ = jax_run
    assert ref.count("-->") == 2 and "hellofromthenewportonthecard" in ref
    assert port_srt(path, recipe, engine, str(tmp_path)) == ref
    mem = InMemoryVideo(frames, 25.0, str(tmp_path / "mem.avi"))
    assert port_srt(mem, recipe, engine, str(tmp_path)) == ref


def test_cli_extract_on_cpu_matches_jax(clip, jax_run):
    path, _, recipe = clip
    area = ",".join(str(v) for v in recipe["area"])
    rc = cli.main(["extract", path, "--area", area, "--mode", "fast", "--language", "en",
                   "--no-word-segmentation", "--device", "cpu"])
    assert rc == 0
    with open(path[: -len(".avi")] + ".srt", encoding="utf-8") as f:
        assert f.read() == jax_run[0]


def test_ocr_engine_reads_what_the_jax_engine_reads(clip, jax_run, engine):
    """Same texts and line boxes on band uploads; scores within 0.02 (the
    JAX engine runs its models in bf16, the port in f32)."""
    _, frames, _ = clip
    band = frames[[10, 20, 30, 36, 50, 60, 70, 80]][:, 550:720]  # the run's batch shape
    got = engine.predict_batch(band, origin=(550, 0))
    ref = jax_run[1].predict_batch(band, origin=(550, 0))
    assert [len(b) for b, _ in got] == [1] * 7 + [0]
    for (g_box, g_res), (r_box, r_res) in zip(got, ref):
        assert [t for t, _ in g_res] == [t for t, _ in r_res]
        np.testing.assert_allclose([p for _, p in g_res], [p for _, p in r_res], atol=0.02)
        np.testing.assert_allclose(np.array(g_box, float), np.array(r_box, float), atol=3)


def test_port_imports_no_jax():
    """In a fresh interpreter with JAX_PLATFORMS unset, the main path and
    the batch surface import none of jax, flax, optax, orbax or vse_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    code = (
        "import sys\n"
        "import vse_tpu_torch.cli, vse_tpu_torch.pipeline.extractor\n"
        "import vse_tpu_torch.video.synth, vse_tpu_torch.weights\n"
        "import vse_tpu_torch.pipeline.multistream, vse_tpu_torch.pipeline.service\n"
        "import vse_tpu_torch.pipeline.isolation, vse_tpu_torch.core.i18n\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vse_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_port_source_imports_vse_tpu():
    pat = re.compile(r"\bvse_tpu\b(?!_torch)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vse_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert not pat.search(n) and n.split(".")[0] not in ("jax", "flax"), (path, n)


def test_entry_points_need_cuda_unless_asked_for_cpu(clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show")
    path, _, recipe = clip
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OcrEngine(language="en")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SubtitleExtractor(path, recipe_area(recipe), VseConfig(word_segmentation=False))
    with pytest.raises(NotImplementedError):  # accurate mode is not ported
        SubtitleExtractor(path, recipe_area(recipe), VseConfig(mode="accurate"), device="cpu")

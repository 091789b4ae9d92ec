"""The port's meshed OCR engine (``OcrEngine(mesh=...)``): one replica a
device of the mesh's data axis, each OCRing its contiguous piece of a
chunk padded to a multiple of the data size. Two CPU replicas against the
port's single-device engine and the JAX package's single-device engine, on
the config of ``tests/test_engine_multichip.py`` (random frames, B 8 and
5), and against the port's single-device engine on the en smoke bands
(real text; that engine's reads of them are held against the JAX
package's by ``tests/test_torch_e2e.py``)."""

import numpy as np
import pytest

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu.core.config import Mode as JaxMode
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.pipeline.ocr_engine import OcrEngine as JaxEngine
from vse_tpu_torch.core.config import Mode, VseConfig
from vse_tpu_torch.parallel.sharding import make_mesh
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.video.synth import load_fixture

SMALL = dict(language="en", det_image_height=64, det_image_width=96, rec_image_height=48,
             rec_image_width=64, max_boxes_per_frame=4)


def engines(jax=True, **config):
    cfg = VseConfig(**config)
    meshed = OcrEngine(language="en", mode=Mode.FAST, config=cfg, device="cpu",
                       mesh=make_mesh(2, devices=["cpu", "cpu"]))
    single = OcrEngine(language="en", mode=Mode.FAST, config=cfg, device="cpu")
    ref = JaxEngine(language="en", mode=JaxMode.FAST, config=JaxConfig(**config)) if jax else None
    return meshed, single, ref


def band_frames(n):
    """``n`` frames [n, 104, 1280, 3]: the three smoke bands, then blanks."""
    bands, _ = load_fixture()
    frames = [bands[f"band{i}"] for i in range(3)]
    frames += [np.zeros_like(frames[0])] * (n - 3)
    return np.stack(frames[:n])


def texts_and_boxes(results):
    return [([t for t, _ in res], box) for box, res in results]


def test_meshed_engine_has_one_replica_a_device():
    meshed = OcrEngine(language="en", config=VseConfig(**SMALL), device="cpu",
                       mesh=make_mesh(2, devices=["cpu", "cpu"]))
    assert len(meshed.replicas) == 2
    a, b = meshed.replicas
    assert a.det_model is meshed.det_model and b.det_model is not a.det_model
    for (_, p), (_, q) in zip(a.rec_model.state_dict().items(), b.rec_model.state_dict().items()):
        assert p.data_ptr() != q.data_ptr() and np.array_equal(p.numpy(), q.numpy())


@pytest.mark.parametrize("seed,batch", [(0, 8), (1, 5), (2, 8)])
def test_random_frames_as_the_single_engines(seed, batch):
    """``tests/test_engine_multichip.py``'s batches: the same results as
    the port's and the JAX package's single-device engines (B 5 pads one
    zero frame, dropped from the output)."""
    meshed, single, ref = ENGINES["small"]
    frames = np.random.default_rng(seed).integers(0, 255, size=(batch, 64, 96, 3),
                                                  dtype=np.uint8)
    got = meshed.predict_batch(frames)
    assert len(got) == batch
    assert got == single.predict_batch(frames)
    assert texts_and_boxes(got) == texts_and_boxes(ref.predict_batch(frames))
    boxes = meshed.detect_batch(frames)
    for x, y in zip(boxes, single.detect_batch(frames)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("batch", [8, 5])
def test_band_frames_read_as_the_single_engines(batch):
    """The en smoke bands (three cues, then blank frames): boxes, texts and
    scores equal the port's single engine's, and both replicas ran."""
    meshed, single, _ = ENGINES["bands"]
    frames = band_frames(batch)
    got = meshed.predict_batch(frames)
    assert got == single.predict_batch(frames)
    # the reads of reference.srt (no word segmentation)
    assert [t for _, res in got[:3] for t, _ in res] == [
        "hellofromthenewportonthecard", "asecondlineoftextcomeshere",
        "andthisisthelastcueoftheclip"]


ENGINES = {}


@pytest.fixture(scope="module", autouse=True)
def built_engines():
    ENGINES["small"] = engines(**SMALL)
    ENGINES["bands"] = engines(jax=False, language="en")
    yield
    ENGINES.clear()

"""The port's multi-device layer (``vse_tpu_torch/parallel/``) against the
JAX package's: the video assignment, the model-parallel spec of every
flax parameter path, and the ``torch.distributed`` bootstrap in two gloo
processes."""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_dist_helpers import free_port, init_worker, run_ranks
from vse_tpu.models.crnn import CRNNRecognizer as JaxCRNN
from vse_tpu.models.db_detector import DBDetector as JaxDet
from vse_tpu.parallel import multihost as jax_mh
from vse_tpu.parallel import sharding as jax_sh
from vse_tpu_torch.parallel import multihost, sharding
from vse_tpu_torch.video.decode import InMemoryVideo
from vse_tpu_torch.weights import load_rec_flat


@settings(max_examples=200, deadline=None)
@given(costs=st.lists(st.floats(0, 1e12, allow_nan=False), max_size=40),
       n_hosts=st.integers(1, 9))
def test_balanced_assignment_equals_jax(costs, n_hosts):
    assert multihost.balanced_assignment(costs, n_hosts) == \
        jax_mh.balanced_assignment(costs, n_hosts)


def videos():
    """Seven in-memory clips of different lengths and sizes (two of equal
    cost: ties break by index)."""
    shapes = [(30, 36, 64), (5, 72, 128), (30, 36, 64), (12, 48, 48), (1, 8, 8), (40, 16, 16),
              (9, 64, 32)]
    return [InMemoryVideo(np.zeros(s + (3,), np.uint8), 25.0, f"v{i}.avi")
            for i, s in enumerate(shapes)]


def test_assign_videos_at_explicit_rank_and_size():
    vids = videos()
    costs = [jax_mh.video_cost(*v.frames.shape[:3]) for v in vids]
    assert [multihost.video_cost(*v.frames.shape[:3]) for v in vids] == costs
    for n in (2, 3, 4):
        want = jax_mh.balanced_assignment(costs, n)
        shares = [multihost.assign_videos(vids, pid, n) for pid in range(n)]
        assert [[int(v.path[1:-4]) for v in s] for s in shares] == want
    # one process (torch.distributed not initialized): everything, in order
    assert multihost.assign_videos(vids) == vids
    assert multihost.assign_videos(vids, 0, 1) == vids


# the class counts of the exported en and ch heads, less the blank
EN_VOCAB = 68
CH_VOCAB = 21059


def jax_trees():
    """The JAX package's variable trees (shapes only): the mobile det with
    its training head, the server det, the en and ch rec heads."""
    key = jax.random.PRNGKey(0)
    det_in = jax.numpy.zeros((1, 64, 64, 3))
    rec_in = jax.numpy.zeros((1, 48, 320, 3))
    return {
        "det_mobile": jax.eval_shape(
            lambda: JaxDet(variant="mobile", train_outputs=True).init(key, det_in, train=True)),
        "det_server": jax.eval_shape(lambda: JaxDet(variant="server").init(key, det_in)),
        "rec_en": jax.eval_shape(
            lambda: JaxCRNN(vocab_size=EN_VOCAB).init(key, rec_in)),
        "rec_ch": jax.eval_shape(
            lambda: JaxCRNN(vocab_size=CH_VOCAB).init(key, rec_in)),
    }


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


def flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from flat(v, p)
        else:
            yield p, v


def test_spec_for_equals_jax_for_every_parameter(trees):
    n = 0
    for name, tree in trees.items():
        for path, leaf in flat(dict(tree)):
            assert sharding.spec_for(path, leaf.shape) == tuple(jax_sh._spec_for(path, leaf)), \
                (name, path)
            n += 1
    assert n > 1000
    for family, vocab in (("en", EN_VOCAB), ("ch", CH_VOCAB)):
        assert load_rec_flat(family)["params/ctc_fc/bias"].shape == (vocab + 1,)
    # the rules: vocab axis, LSTM gates, wide convolutions, else replicated
    assert sharding.spec_for("params/ctc_fc/kernel", (96, 69)) == (None, "model")
    assert sharding.spec_for("params/ctc_fc/bias", (69,)) == ("model",)
    assert sharding.spec_for("params/x/Conv_0/kernel", (3, 3, 64, 256)) == (None,) * 3 + ("model",)
    assert sharding.spec_for("params/x/Conv_0/kernel", (3, 3, 64, 255)) == ()


def test_mesh_and_placements():
    mesh = sharding.make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4, "model": 1} and mesh.size == 4
    assert sharding.make_mesh(2, 2, devices=["cpu"] * 4).data_devices == [torch.device("cpu")] * 2
    x = torch.arange(8).reshape(4, 2)
    pieces = sharding.data_sharding(mesh).shard(x)
    assert [p.tolist() for p in pieces] == [[[0, 1]], [[2, 3]], [[4, 5]], [[6, 7]]]
    with pytest.raises(ValueError, match="does not split"):
        sharding.data_sharding(mesh).shard(torch.zeros(6))
    with pytest.raises(ValueError, match="needs 6 devices"):
        sharding.make_mesh(3, 2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()


def test_initialize_two_gloo_processes():
    """Two spawned processes rendezvous through ``COORDINATOR_ADDRESS`` /
    ``NUM_PROCESSES`` (rank 0 by ``process_id=0``, which must not fall
    through to ``PROCESS_ID``), all-reduce, and each takes its
    ``assign_videos`` share by its rank: disjoint, together everything,
    as JAX's assignment."""
    vids = videos()
    costs = [jax_mh.video_cost(*v.frames.shape[:3]) for v in vids]
    out = run_ranks(init_worker, 2, free_port(), vids)
    want = jax_mh.balanced_assignment(costs, 2)
    for rank in (0, 1):
        r = out[rank]
        assert (r["rank"], r["world"], r["backend"], r["sum"]) == (rank, 2, "gloo", 3.0)
        assert r["share"] == [f"v{i}.avi" for i in want[rank]]


def test_initialize_without_an_address_takes_torchrun_env(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
                 "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    multihost.initialize()
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        vids = videos()
        assert multihost.assign_videos(vids) == vids
    finally:
        dist.destroy_process_group()


def test_new_modules_import_without_jax_pil_or_cv2():
    """The modules of this slice import with JAX, the JAX package, PIL,
    OpenCV and matplotlib blocked (the card's machine has none of them),
    and the stroke / CJK tables build there."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('PIL', 'cv2', 'matplotlib', 'fontTools', 'jax', 'optax', 'flax', 'vse_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import vse_tpu_torch.eval, vse_tpu_torch.utils, vse_tpu_torch.utils.tracing\n"
        "import vse_tpu_torch.parallel.multihost, vse_tpu_torch.parallel.sharding\n"
        "import vse_tpu_torch.train.steps, vse_tpu_torch.pipeline.ocr_engine\n"
        "from vse_tpu_torch.core.strokefont import stroke_script_for\n"
        "assert all(stroke_script_for(f) for f in ('th', 'devanagari', 'ta', 'te', 'ch',"
        " 'chinese_cht', 'japan'))\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

"""The port's joint det + rec train step (``vse_tpu_torch/train/steps.py``)
against the JAX package's ``vse_tpu/train/steps.py``.

Compiling the JAX joint step on the CPU takes minutes (61 s for the f32
modules and 159 s for the bf16 ones at the tiny shapes below, and
``init_state`` alone 105 s), so the port is held against what
``tools/make_torch_smoke_fixture.py --joint`` wrote with JAX: its
``init_state`` for en at seed 0 (``train_joint_init.npz``), the tiny
batch, 5 steps' losses of the bf16 step (``make_models``) and of the same
modules at f32, and the f32 run's parameters after them
(``reference_joint_tiny.npz``, ``reference_joint.json``), and
(``--joint-grads``) the f32 step's first gradients
(``reference_joint_grads.npz``). The live comparisons are the JAX
objective itself (``db_loss`` + ``ctc_rec_loss``) on the step's outputs
and the JAX variable tree's paths and shapes.

Then the data axis: two gloo processes, each with half of the batch
(2 + 2), and a (1, 2) mesh, each against the one-process step.

The gradients are compared leaf by leaf before the optimizer, since adam
is scale-invariant: a gradient off by a factor, or a leaf moved the wrong
way by a small step, hardly shows in 5 steps' losses."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_helpers import (final_variables, flax_grads, free_port, keep_first_grads,
                                 run_ranks, split_init, train_worker)
from _torch_helpers import two_threads  # noqa: F401
from vse_tpu.train import losses as jax_losses
from vse_tpu.train import steps as jax_steps
from vse_tpu_torch.parallel.sharding import make_mesh
from vse_tpu_torch.train import pretrain
from vse_tpu_torch.train import steps as S
from vse_tpu_torch.train import synth as ts
from vse_tpu_torch.video.synth import SMOKE_FIXTURE

INIT = os.path.join(SMOKE_FIXTURE, "train_joint_init.npz")
with open(os.path.join(SMOKE_FIXTURE, "reference_joint.json"), encoding="utf-8") as _f:
    REF = json.load(_f)
TINY = dict(det_h=32, det_w=64, rec_h=48, rec_w=64, max_label_len=6, min_font=10, max_font=14)
CPU = make_mesh(1, 1, devices=["cpu"])


def init_flat():
    with np.load(INIT) as z:
        return {k: z[k] for k in z.files}


def tiny_batch():
    with np.load(os.path.join(SMOKE_FIXTURE, "reference_joint_tiny.npz")) as z:
        return {k[6:]: z[k] for k in z.files if k.startswith("batch/")}


def jax_final_params():
    flat = init_flat()
    with np.load(os.path.join(SMOKE_FIXTURE, "reference_joint_tiny.npz")) as z:
        return {k[6:]: flat[k[6:]] + z[k].astype(np.float32)
                for k in z.files if k.startswith("delta/")}


def jax_first_grads():
    """The JAX f32 step's first gradients, flat flax keys."""
    with np.load(os.path.join(SMOKE_FIXTURE, "reference_joint_grads.npz")) as z:
        return {k[5:]: z[k].astype(np.float32) * z["scale/" + k[5:]]
                for k in z.files if k.startswith("grad/")}


def port_run(batch, mesh=CPU):
    det, rec = S.make_models(REF["vocab"], device="cpu")
    state, tx = S.load_state(det, rec, *split_init(init_flat()), lr=REF["lr"])
    seen = []
    step = S.make_train_step(det, rec, keep_first_grads(tx, seen), mesh)
    state = S.shard_state(mesh, state)
    local = S.place_batch(mesh, batch)
    runs = {"loss": [], "det_loss": [], "rec_loss": []}
    outputs = None
    for i in range(REF["steps"]):
        if i == 0:
            outputs = first_outputs(det, rec, state, local)
        state, metrics = step(state, local)
        for k in runs:
            runs[k].append(float(metrics[k]))
    runs["grads"] = flax_grads(det, rec, seen[0])
    return runs, final_variables(det, rec, state), state, outputs


# leaves whose gradient is 0 in exact arithmetic, rounding noise here: the
# BatchNorm bias after a block's projection and the transposed-conv biases
# a BatchNorm follows; and the expansion BatchNorm scales of the first
# blocks, which only the epsilon keeps from 0 (each at most 1e-4 of its
# model's largest gradient)
AT_NOISE = re.compile(r"(ConvBNAct_2/BatchNorm_0/bias|ConvTranspose_0/bias"
                      r"|ConvBNAct_0/BatchNorm_0/scale)$")


def assert_grads_close(got, want, rtol=1e-2, noise_tol=1e-5):
    """Each leaf of ``got`` within ``rtol`` of its own largest ``want``
    magnitude; a leaf whose own is at most 1e-4 of its model's largest
    (only those ``AT_NOISE`` names) within ``noise_tol`` of the model's
    largest. Returns the worst error relative to its bound, and its leaf."""
    assert sorted(got) == sorted(want)
    gmax = {m: max(float(np.abs(v).max()) for k, v in want.items() if k.startswith(m))
            for m in ("det/", "rec/")}
    worst = (0.0, "")
    for k, w in want.items():
        scale, top = float(np.abs(w).max()), gmax[k[:4]]
        bound = rtol * scale
        if scale <= 1e-4 * top:
            assert AT_NOISE.search(k), (k, scale, top)
            bound = noise_tol * top
        worst = max(worst, (float(np.abs(got[k] - w).max()) / bound, k))
    assert worst[0] <= 1.0, worst
    return worst


def first_outputs(det, rec, state, batch):
    """The models' training-mode outputs at the init (running statistics
    left as they are)."""
    from torch.func import functional_call

    with torch.no_grad():
        dv = {k: v.clone() for k, v in state.det_params.items()}
        rv = {k: v.clone() for k, v in state.rec_params.items()}
        det.train()
        rec.train()
        prob, thresh, binary = functional_call(det, dv, (batch["det_images"],))
        logits = functional_call(rec, rv, (batch["rec_images"],))
    return prob, thresh, binary, logits


@pytest.fixture(scope="module")
def one_process():
    return port_run(tiny_batch())


@pytest.fixture(scope="module")
def two_ranks():
    """The 2-rank gloo runs, a (2, 1) and a (1, 2) mesh."""
    return run_ranks(train_worker, 2, free_port(), INIT, tiny_batch(), REF["vocab"],
                     REF["steps"], REF["lr"], [(2, 1), (1, 2)])


def test_tiny_batch_is_the_port_renderers():
    """The committed batch is what the port's renderer draws from the same
    charset and seed (byte-equal to the JAX renderer's)."""
    charset = pretrain._rec_train_charset("en", False, True)
    assert charset.vocab_size == REF["vocab"]
    got = ts.TextRenderer(charset, ts.SynthConfig(**TINY), seed=REF["seed"]).combined_batch(4)
    want = tiny_batch()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_init_fits_the_jax_variable_tree():
    """Every array of the committed init has the path and shape of
    ``make_models``' variables (``jax.eval_shape`` of their init), and the
    port's models take them whole."""
    det, rec = jax_steps.make_models(REF["vocab"])
    key = jax.random.PRNGKey(0)
    trees = {"det": jax.eval_shape(lambda: det.init(key, jnp.zeros((1, 64, 64, 3)), train=True)),
             "rec": jax.eval_shape(lambda: rec.init(key, jnp.zeros((1, 48, 320, 3))))}
    want = {}
    for m, tree in trees.items():
        stack = [(m, dict(tree))]
        while stack:
            prefix, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((f"{prefix}/{k}", v))
                else:
                    want[f"{prefix}/{k}"] = tuple(v.shape)
    flat = init_flat()
    assert {k: v.shape for k, v in flat.items()} == want
    pdet, prec = S.make_models(REF["vocab"], device="cpu")
    state, _ = S.load_state(pdet, prec, *split_init(flat))
    back = final_variables(pdet, prec, state)
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_five_steps_match_the_jax_step(one_process):
    """The losses within rtol 1e-3 of the JAX step with f32 modules (the
    port computes in f32) and 2e-3 of ``make_models``' bf16 step (which is
    7.5e-4 from the f32 one); each det and rec loss within 2e-3 of the f32
    step's and 1e-2 of the bf16 step's (whose det loss is 5.6e-3 from the
    f32 one's); each trainable parameter within 0.0125 of the f32 JAX run's
    (2.5 adam steps of lr 1e-3 at their largest: a gradient at rounding
    noise, as that of a bias a BatchNorm follows, takes a full step either
    way; measured 0.0067), and 97% of them within 1e-3 (measured 98.8%;
    adam's normalization gives a small gradient a step of lr whatever its
    size, so a last-bit difference in it moves its parameter by up to
    ~1e-3 in 5 steps). The loss falls."""
    runs, final, state, _ = one_process
    for dtype, rtol, term_rtol in (("f32", 1e-3, 2e-3), ("bf16", 2e-3, 1e-2)):
        np.testing.assert_allclose(runs["loss"], REF["tiny"][dtype]["loss"], rtol=rtol)
        for k in ("det_loss", "rec_loss"):
            np.testing.assert_allclose(runs[k], REF["tiny"][dtype][k], rtol=term_rtol)
    assert runs["loss"][-1] < runs["loss"][0]
    assert int(state.step) == REF["steps"]
    want = jax_final_params()
    diffs = np.concatenate([np.abs(final[k] - v).ravel() for k, v in want.items()])
    assert diffs.max() <= 0.0125
    assert (diffs <= 1e-3).mean() >= 0.97


def test_first_step_gradients_match_the_jax_step(one_process):
    """The first step's gradients, as the optimizer gets them, leaf by
    leaf against the JAX f32 step's (``assert_grads_close``): each within
    1e-2 of its own largest magnitude (measured 3.1e-3 at two threads, the
    threshold head's first BatchNorm bias, a sum with much cancellation;
    3.2e-4 at the machine's thread count, about what the fixture's f16
    storage allows), the noise leaves within 1e-5 of their model's largest
    (measured 6.4e-7)."""
    runs = one_process[0]
    assert_grads_close(runs["grads"], jax_first_grads())


def test_jax_objective_on_the_port_outputs(one_process):
    """The JAX package's ``db_loss`` + ``ctc_rec_loss`` on the port's
    first-step outputs equal the port's first loss (the joint objective,
    live)."""
    runs, _, _, (prob, thresh, binary, logits) = one_process
    b = tiny_batch()
    dloss, _ = jax.jit(jax_losses.db_loss)(
        *(jnp.asarray(t.numpy()) for t in (prob, thresh, binary)),
        *(jnp.asarray(b[k]) for k in ("gt_shrink", "gt_shrink_mask", "gt_thresh",
                                      "gt_thresh_mask")))
    rloss = jax.jit(jax_losses.ctc_rec_loss)(jnp.asarray(logits.numpy()),
                                             jnp.asarray(b["labels"]),
                                             jnp.asarray(b["label_lengths"]))
    np.testing.assert_allclose(runs["det_loss"][0], float(dloss), rtol=1e-5)
    np.testing.assert_allclose(runs["rec_loss"][0], float(rloss), rtol=1e-5)


def test_gloo_data_axis_and_model_axis_equal_one_process(one_process, two_ranks):
    """Two gloo ranks: a (2, 1) mesh gives each rank 2 of the 4 samples,
    with the BatchNorm statistics, the hard-negative sort and the means of
    the global batch, and the gradients averaged; a (1, 2) mesh gives each
    rank the whole batch (the model axis is a layout). Both match the
    one-process step: the first loss within rtol 1e-6 (the forward and its
    statistics differ in summation order only), the 5 losses within rtol
    1e-3 (measured 2.4e-4 after adam's steps), every parameter within
    0.0125 and 97% within 1e-3 (measured 98.7%; adam's first steps, as
    above)."""
    runs, final, _, _ = one_process
    out = two_ranks
    for shape, batch in (((2, 1), 2), ((1, 2), 4)):
        for rank in (0, 1):
            got = out[rank][shape]
            assert got["batch"] == batch, shape
            np.testing.assert_allclose(got["losses"][0], runs["loss"][0], rtol=1e-6)
            np.testing.assert_allclose(got["losses"], runs["loss"], rtol=1e-3)
            diffs = np.concatenate([np.abs(got["variables"][k] - v).ravel()
                                    for k, v in final.items() if "/params/" in k])
            assert diffs.max() <= 0.0125 and (diffs <= 1e-3).mean() >= 0.97, (shape, rank)
        # the ranks of a run hold the same variables
        a, b = out[0][shape]["variables"], out[1][shape]["variables"]
        assert all(np.array_equal(a[k], b[k]) for k in a), shape


def test_gloo_first_gradients_equal_one_process(one_process, two_ranks):
    """The first step's gradients after the data axis's all-reduce and
    average, as the optimizer gets them, leaf by leaf against the
    one-process step's on both ranks of the (2, 1) and the (1, 2) mesh,
    with ``assert_grads_close``'s bounds (measured 3.7e-3 of a leaf's own
    scale and 1.4e-6 of its model's largest: one thread a rank against
    two). A missing or doubled average, or a hard-negative share that
    misses the other rank's part, is off by a factor and fails here."""
    want = one_process[0]["grads"]
    for shape in ((2, 1), (1, 2)):
        for rank in (0, 1):
            assert_grads_close(two_ranks[rank][shape]["grads"], want)


def test_mesh_rules_in_one_process():
    """One process takes a (1, m) mesh and refuses a data axis > 1;
    ``place_batch`` needs B to divide over the data axis; the state stays
    whole over the model axis."""
    batch = tiny_batch()
    runs, _, state, _ = port_run(batch, make_mesh(1, 2, devices=["cpu", "cpu"]))
    np.testing.assert_allclose(runs["loss"], REF["tiny"]["f32"]["loss"], rtol=1e-3)
    assert_grads_close(runs["grads"], jax_first_grads())
    det, rec = S.make_models(REF["vocab"], device="cpu")
    assert all(state.rec_params[k].shape == v.shape for k, v in rec.state_dict().items())
    with pytest.raises(ValueError, match="one process per device"):
        S.place_batch(make_mesh(2, 1, devices=["cpu", "cpu"]), batch)
    state, tx = S.init_state(det, rec)
    with pytest.raises(ValueError, match="one process per device"):
        S.make_train_step(det, rec, tx, make_mesh(2, 1, devices=["cpu", "cpu"]))
    assert set(state.det_params) == set(det.state_dict())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where CUDA is absent")
def test_the_step_runs_on_the_card_unless_given_a_cpu_mesh():
    """``make_models`` and a step with no mesh take the card (and raise
    where CUDA is absent, as every entry point of the port does); a CPU
    mesh runs the step on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.make_models(REF["vocab"])
    det, rec = S.make_models(REF["vocab"], device="cpu")
    state, tx = S.init_state(det, rec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.make_train_step(det, rec, tx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.place_batch(None, tiny_batch())
    step = S.make_train_step(det, rec, tx, CPU)
    state, metrics = step(state, S.place_batch(CPU, tiny_batch()))
    assert {v.device.type for v in (*state.det_params.values(), *state.rec_params.values())} \
        == {"cpu"}
    assert np.isfinite(float(metrics["loss"]))

"""Workers for the port's multi-process CPU tests (gloo), spawned by
``tests/test_torch_parallel.py`` and ``tests/test_torch_train_steps.py``.
They import neither JAX nor the JAX package."""

from __future__ import annotations

import os
import socket
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target, world: int, *args, timeout: float = 180.0) -> dict:
    """``target(rank, world, queue, *args)`` in ``world`` spawned processes;
    {rank: what each put on the queue}. Fails (and kills the workers) when
    one exits non-zero or gives nothing within ``timeout`` seconds."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(rank, world, q) + args) for rank in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, value = q.get(timeout=1.0)
                out[rank] = value
                continue
            except queue_mod.Empty:
                pass
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise AssertionError(f"a worker exited with {failed[0]} before its result")
            if time.monotonic() > deadline:
                raise AssertionError(f"a worker gave no result within {timeout} s")
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                raise AssertionError(f"worker {p.pid} did not exit")
            if p.exitcode != 0:
                raise AssertionError(f"worker {p.pid} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return out


def init_worker(rank: int, world: int, q, port: int, videos) -> None:
    """``multihost.initialize`` through the env fallbacks (rank 0 passes
    ``process_id=0``, which must beat a wrong ``PROCESS_ID``), one
    all-reduce, and this rank's ``assign_videos`` share."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from vse_tpu_torch.parallel import multihost

    os.environ["COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["NUM_PROCESSES"] = str(world)
    os.environ["PROCESS_ID"] = str(world - 1 - rank)  # wrong on purpose
    multihost.initialize(process_id=rank)
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    share = [v.path for v in multihost.assign_videos(videos)]
    q.put((rank, {"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "backend": dist.get_backend(), "sum": float(x), "share": share}))
    dist.destroy_process_group()


def train_worker(rank: int, world: int, q, port: int, init_npz: str, batch, vocab: int,
                 steps: int, lr: float, shapes) -> None:
    """The joint step on a gloo group, for each mesh shape in ``shapes``:
    fresh models from ``init_npz``, ``place_batch`` of the global
    ``batch``, ``steps`` steps. Puts each shape's losses, first gradients
    (as the optimizer got them) and final variables (flat flax keys)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from vse_tpu_torch.parallel import multihost
    from vse_tpu_torch.parallel.sharding import make_mesh
    from vse_tpu_torch.train import steps as S

    multihost.initialize(f"127.0.0.1:{port}", world, rank)
    out = {}
    with np.load(init_npz) as z:
        flat = {k: z[k] for k in z.files}
    for n_data, n_model in shapes:
        mesh = make_mesh(n_data, n_model, devices=["cpu"] * world)
        det, rec = S.make_models(vocab, device="cpu")
        state, tx = S.load_state(det, rec, *split_init(flat), lr=lr)
        seen = []
        step = S.make_train_step(det, rec, keep_first_grads(tx, seen), mesh)
        state = S.shard_state(mesh, state)
        local = S.place_batch(mesh, batch)
        losses = []
        for _ in range(steps):
            state, metrics = step(state, local)
            losses.append(float(metrics["loss"]))
        out[(n_data, n_model)] = {
            "losses": losses, "batch": int(local["det_images"].shape[0]),
            "grads": flax_grads(det, rec, seen[0]),
            "variables": final_variables(det, rec, state)}
    q.put((rank, out))
    dist.destroy_process_group()


def split_init(flat):
    """The committed joint init (keys ``det/...``, ``rec/...``) as the two
    models' flat flax variables."""
    det = {k[4:]: v for k, v in flat.items() if k.startswith("det/")}
    rec = {k[4:]: v for k, v in flat.items() if k.startswith("rec/")}
    return det, rec


def final_variables(det, rec, state) -> dict:
    """The state's variables as flat flax arrays under ``det/`` and
    ``rec/``."""
    from vse_tpu_torch.weights import to_jax_det, to_jax_params

    out = {f"det/{k}": v for k, v in to_jax_det(state.det_params).items()}
    out.update({f"rec/{k}": v for k, v in to_jax_params(state.rec_params).items()})
    return out


def keep_first_grads(tx, seen: list):
    """``tx`` that also puts a copy of the gradients of its first update
    into ``seen``."""
    from vse_tpu_torch.train import optim

    def update(grads, state, params):
        if not seen:
            seen.append([g.detach().clone() for g in grads])
        return tx.update(grads, state, params)

    return optim.Transform(tx.init, update)


def flax_grads(det, rec, grads) -> dict:
    """A step's gradients (the trainable parameters in order, det's then
    rec's) as flat flax arrays under ``det/params/`` and ``rec/params/``."""
    import torch

    from vse_tpu_torch.weights import to_jax_det, to_jax_params

    it = iter(grads)
    out = {}
    for m, model, to_flax in (("det", det, to_jax_det), ("rec", rec, to_jax_params)):
        sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
        for k, p in model.named_parameters():
            if p.requires_grad:
                sd[k] = next(it)
        out.update({f"{m}/{k}": v for k, v in to_flax(sd).items() if k.startswith("params/")})
    assert next(it, None) is None
    return out

"""Multi-host orchestration over ``torch.distributed`` (the port of
``vse_tpu/parallel/multihost.py``).

Subtitle extraction is embarrassingly parallel at the VIDEO level: hosts
never exchange frames, so the network carries only the work assignment.
This module provides the ``torch.distributed`` bootstrap and a
deterministic video -> process assignment that balances the estimated
decode + OCR cost (frame_count x resolution) rather than the video count.
Within a process, ``OcrEngine(mesh=make_mesh())`` spreads frame chunks over
the local cards (``parallel/sharding.py``).

Run one process per host (or per card), e.g. under ``torchrun``:

    import vse_tpu_torch.parallel.multihost as mh
    mh.initialize()                       # torch.distributed rendezvous
    mine = mh.assign_videos(videos)       # this process's share
    extract_many(mine, ...)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``torch.distributed.init_process_group`` with the JAX package's
    env-var fallbacks: ``COORDINATOR_ADDRESS`` (``host:port``, or a
    ``tcp://`` URL) is the rendezvous, ``NUM_PROCESSES`` the world size and
    ``PROCESS_ID`` the rank. With no address at all, the ``env://``
    rendezvous that ``torchrun`` sets up (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). The backend is NCCL where CUDA is available,
    else gloo."""
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator_address:
        dist.init_process_group(backend=backend, init_method="env://")
        return
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    # `is not None`, not truthiness: process_id=0 is the coordinator and
    # must not fall through to the env var
    world = num_processes if num_processes is not None else int(os.environ["NUM_PROCESSES"])
    rank = process_id if process_id is not None else int(os.environ["PROCESS_ID"])
    dist.init_process_group(backend=backend, init_method=coordinator_address,
                            world_size=world, rank=rank)


def video_cost(frame_count: int, height: int, width: int) -> float:
    """Relative decode+OCR cost estimate: frames x pixels."""
    return float(frame_count) * float(height * width)


def balanced_assignment(
    costs: Sequence[float], n_hosts: int
) -> List[List[int]]:
    """Greedy longest-processing-time assignment of indexed costs to hosts.

    Deterministic (ties break by index) so every host computes the SAME
    assignment without communicating."""
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    loads = [0.0] * n_hosts
    buckets: List[List[int]] = [[] for _ in range(n_hosts)]
    for i in order:
        h = min(range(n_hosts), key=lambda j: (loads[j], j))
        buckets[h].append(i)
        loads[h] += costs[i]
    for b in buckets:
        b.sort()
    return buckets


def assign_videos(videos: Sequence, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> list:
    """This process's share of ``videos`` (paths or ``InMemoryVideo``s;
    cost-balanced, deterministic across processes). The rank and world size
    default to ``torch.distributed``'s when it is initialized, else 0 and
    1."""
    from vse_tpu_torch.video.decode import probe

    up = dist.is_available() and dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    n = (dist.get_world_size() if up else 1) if num_processes is None else num_processes
    if n <= 1:
        return list(videos)
    costs = []
    for v in videos:
        m = probe(v)
        costs.append(video_cost(m.frame_count, m.height, m.width))
    buckets = balanced_assignment(costs, n)
    return [videos[i] for i in buckets[pid]]

"""Spawn-picklable child targets for tests/test_torch_isolation.py (a
spawned child imports this module by name, so the fakes cannot live inside
the test functions). Each takes the port's child signature: (video,
area, output path, config kwargs, device, queue, cancel event)."""

import os
import time


def child_ok(video_path, area_tuple, output_path, cfg, device, q, cancel):
    from vse_tpu_torch.pipeline.isolation import Command

    q.put((Command.PID, os.getpid()))
    q.put((Command.PROGRESS, (50.0, 10.0)))
    q.put((Command.LOG, f"hello from child on {device}"))
    q.put((Command.FINISH, output_path or "/tmp/out.srt"))


def child_crash(video_path, area_tuple, output_path, cfg, device, q, cancel):
    from vse_tpu_torch.pipeline.isolation import Command

    q.put((Command.PID, os.getpid()))
    os._exit(3)  # dies without reporting


def child_hang(video_path, area_tuple, output_path, cfg, device, q, cancel):
    from vse_tpu_torch.pipeline.isolation import Command

    q.put((Command.PID, os.getpid()))
    while True:  # ignores the cooperative cancel event
        time.sleep(0.2)


def child_cooperative(video_path, area_tuple, output_path, cfg, device, q, cancel):
    from vse_tpu_torch.pipeline.isolation import Command

    q.put((Command.PID, os.getpid()))
    cancel.wait(timeout=30)
    q.put((Command.ERROR, "cancelled cooperatively"))

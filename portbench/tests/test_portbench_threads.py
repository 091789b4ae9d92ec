"""A process that starts ``run.py`` as its entry point runs with the thread
counts that ``run.THREADS`` states, in every pool it names."""

import json
import os
import subprocess
import sys

from _helpers import PB, ROOT

import run


def test_entry_point_fixes_the_thread_pools():
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                        "OPENCV_FFMPEG_THREADS")}
    env["OMP_NUM_THREADS"] = "7"  # a caller's setting does not leak through
    out = subprocess.run([sys.executable, os.path.join(PB, "run.py"), "--workload", "no-such-cell",
                          "--seed", "1", "--seconds", "1", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    line = next(l for l in out.stderr.splitlines() if l.startswith("threads: "))
    seen = json.loads(line[len("threads: "):])
    want = run.THREADS
    assert (seen["torch"], seen["cv2"], seen["ffmpeg"]) == (want["torch"], want["cv2"],
                                                            want["ffmpeg"])
    libs = {tuple(x) for x in seen["libs"]}
    assert {n for api, n in libs if api == "openblas"} == {want["blas"]}
    assert {n for api, n in libs if api == "openmp"} <= {want["torch"]}

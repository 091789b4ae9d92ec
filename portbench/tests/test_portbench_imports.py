"""Neither the harness nor the reference loads JAX or the JAX package, and
the reference loads nothing of the program."""

import subprocess
import sys

from _helpers import PB, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vse_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=PB, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{PB}:{ROOT}"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = _loaded("import run, judge, tracer, devtrace, yardstick, roofline, calibrate\n"
                    "from vse_tpu_torch.pipeline import extractor, ocr_engine")
    assert not names & FORBIDDEN
    assert "vse_tpu_torch" in names


def test_reference_loads_nothing_of_the_program():
    names = _loaded("from reference import clip, models, ocr, post, scan")
    assert not names & (FORBIDDEN | {"vse_tpu_torch"})

"""The program's own spans and counters (``vse_tpu_torch/utils/tracing.py``).

Nothing is wrapped from here: the program records its stages itself. A
traced run loads this file after the warm-up clip, and loading it switches
the program's recorder on, so that the window's clips are recorded and the
untraced runs, which give the end-to-end metrics, never are. A program
without the recorder is left as it is, and the metrics that read it
(``recorder.py``) report nothing."""

from vse_tpu_torch.utils import tracing as _tracing

LAYER = "the program's own spans and counters (utils/tracing.py)"
WRAPS = []

if hasattr(_tracing, "record"):
    _tracing.clear()
    _tracing.record(True)

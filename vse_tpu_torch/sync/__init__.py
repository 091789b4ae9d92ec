"""Audio-correlation subtitle re-timer ("Timeline Sync"), the port of
``vse_tpu/sync/``.

Shifts an existing SRT/ASS script from one cut of a video to another by
matching per-group audio fingerprints (the reference's bundled sushi tool,
backend/sushi/). See vse_tpu_torch/sync/engine.py for the algorithm and
vse_tpu_torch/sync/cli.py for the CLI (the JAX package's flags and
``--device``).
"""

from vse_tpu_torch.sync.common import SyncError
from vse_tpu_torch.sync.runner import run

__all__ = ["run", "SyncError"]

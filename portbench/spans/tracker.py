"""Per-frame detection's span tracker (``DetSpanTracker``)."""

LAYER = "per-frame detection (DetSpanTracker)"
WRAPS = [
    ("vse_tpu_torch.pipeline.extractor", "DetSpanTracker.feed", "tracker"),
    ("vse_tpu_torch.pipeline.extractor", "DetSpanTracker.finish", "tracker"),
]

"""Keyframe scan (``pipeline/extractor.py``'s scan pass)."""

LAYER = "keyframe scan (pipeline/extractor.py scan pass)"
WRAPS = [("vse_tpu_torch.pipeline.extractor", "SubtitleExtractor.scan_keyframe_spans", "scan")]

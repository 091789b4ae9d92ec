"""The OCR step (``pipeline/ocr_engine.py``): det, postprocess, crops, rec
and decode of one chunk of frames; and each det or rec forward with its
input shape, which the FLOP count of the whole OCR pipeline reads."""

LAYER = "OCR step (pipeline/ocr_engine.py, models/)"
WRAPS = [
    ("vse_tpu_torch.pipeline.ocr_engine", "OcrEngine.ocr_arrays", "ocr_step"),
    ("vse_tpu_torch.models.graphed", "GraphedForward.__call__", "forward", True),
]

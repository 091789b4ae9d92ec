"""Decode and frame queue (``video/decode.py``): each frame the stream's
reader thread decodes, and each sample read of the keyframe OCR pass."""

LAYER = "decode and frame queue (video/decode.py)"
WRAPS = [
    ("vse_tpu_torch.video.decode", "FrameStream._frames", "decode"),
    ("vse_tpu_torch.pipeline.extractor", "read_frames", "decode"),
]

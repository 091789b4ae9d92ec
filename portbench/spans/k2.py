"""K2, the keyframe stats kernel: each launch with its band's shape."""

LAYER = "K2 (kernels/keyframe.py, csrc/keyframe.cu)"
WRAPS = [("vse_tpu_torch.pipeline.extractor", "scan_stats_u8", "k2", True)]

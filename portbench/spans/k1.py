"""K1, the greedy CTC decode kernel: each launch with its logits' shape."""

LAYER = "K1 (kernels/ctc_decode.py, csrc/ctc_decode.cu)"
WRAPS = [("vse_tpu_torch.pipeline.ocr_engine", "ctc_greedy_decode", "k1", True)]

"""CRNN text recognizer (the port of ``vse_tpu/models/crnn.py``):
MobileNetV3 features -> 2 x BiLSTM -> CTC projection.

The flax BiLSTM's forward cell is ``lstmN/OptimizedLSTMCell_0`` and its
backward cell ``_1``; both use the i, f, g, o gate order of ``nn.LSTM``
(``weights.from_jax_params`` maps them).

``forward`` computes in f32 (the architecture check against the flax module
in f32, on the f32-stored en head); after ``models.bf16.emulate`` it
reproduces the reference's bf16 numerics (``models/bf16.py``). A head
stored as bf16 bits (``rec_ch_mobile``, see ``weights.py``) gives
``forward`` its rounded weights."""

from __future__ import annotations

import torch
import torch.nn as nn

from vse_tpu_torch.models import bf16 as B16

from vse_tpu_torch.models.mobilenet_v3 import MobileNetV3Rec


class CRNNRecognizer(nn.Module):
    """variant "mobile": MobileNetV3-small x0.5, BiLSTM hidden 48; "server":
    MobileNetV3-large x1.0, hidden 256. ``hidden`` / ``cnn_scale`` override
    those defaults (a head records them in its vse_meta.json).

    flax's LSTM cell has one bias a gate, on its hidden dense;
    ``nn.LSTM``'s ``bias_ih`` stays zero and frozen (``requires_grad``
    False), so the effective bias is ``bias_hh`` alone and an optimizer
    moves it as the JAX package's moves its one bias."""

    def __init__(self, vocab_size: int, hidden: int = 0, cnn_scale: float = 0.0,
                 variant: str = "mobile"):
        super().__init__()
        if variant not in ("mobile", "server"):
            raise ValueError(f"unknown rec variant {variant}")
        self.bf16 = False
        large = variant == "server"
        hid = hidden or (256 if large else 48)
        self.backbone = MobileNetV3Rec(cnn_scale or (1.0 if large else 0.5),
                                       arch="large" if large else "small")
        feat = self.backbone.out_channels
        self.lstm1 = nn.LSTM(feat, hid, batch_first=True, bidirectional=True)
        self.lstm2 = nn.LSTM(2 * hid, hid, batch_first=True, bidirectional=True)
        self.ctc_fc = nn.Linear(2 * hid, vocab_size + 1)
        with torch.no_grad():
            for lstm in (self.lstm1, self.lstm2):
                for name, p in lstm.named_parameters():
                    if name.startswith("bias_ih"):
                        p.zero_()
                        p.requires_grad_(False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] normalized crops -> logits [B, W//4, C]."""
        if self.bf16:
            x = self.backbone.forward_bf16(images.permute(0, 3, 1, 2))
            x = B16.bilstm(self.lstm2, B16.bilstm(self.lstm1, x))
            return B16.rb(B16.rb(x) @ self.ctc_fc.weight.T) + self.ctc_fc.bias
        x = self.backbone(images.permute(0, 3, 1, 2))
        x, _ = self.lstm1(x)
        x, _ = self.lstm2(x)
        return self.ctc_fc(x)

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
    """The mobile head: MobileNetV3-small x0.5, BiLSTM hidden 48. ``hidden``
    / ``cnn_scale`` override those defaults (a head records them in its
    vse_meta.json). The server variant is not ported yet."""

    def __init__(self, vocab_size: int, hidden: int = 0, cnn_scale: float = 0.0):
        super().__init__()
        self.bf16 = False
        hid = hidden or 48
        self.backbone = MobileNetV3Rec(cnn_scale or 0.5)
        feat = self.backbone.out_channels
        self.lstm1 = nn.LSTM(feat, hid, batch_first=True, bidirectional=True)
        self.lstm2 = nn.LSTM(2 * hid, hid, batch_first=True, bidirectional=True)
        self.ctc_fc = nn.Linear(2 * hid, vocab_size + 1)

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

"""The FLOP and byte counters against shapes worked by hand, and the
forwards of both configurations against the integers that the counter gave
before it found each model by its kind."""

import pytest
import torch
import torch.nn as nn

from _helpers import config

import yardstick as Y


def test_kernel_bytes():
    # the kernel table's K1 bound at [64, 80, 21060] f32: 128.8 us at 3.35 TB/s
    assert Y.k1_bytes(64, 80, 21060) == 64 * 80 * 21060 * 4 + 64 * 80 * 5 + 64 * 4
    assert abs(Y.k1_bytes(64, 80, 21060) / Y.PEAK_HBM_BYTES * 1e6 - 128.76) < 0.01
    # K2 at [32, 104, 1280, 3]: 3.815 us
    assert Y.k2_bytes(32, 104, 1280) == 32 * 104 * 1280 * 3 + 32 * 16
    assert abs(Y.k2_bytes(32, 104, 1280) / Y.PEAK_HBM_BYTES * 1e6 - 3.815) < 0.001


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 4, 3, padding=1)
        self.d = nn.Conv2d(4, 4, 3, padding=1, groups=4)
        self.t = nn.ConvTranspose2d(4, 2, 2, stride=2)
        self.lstm = nn.LSTM(16, 5, batch_first=True, bidirectional=True)
        self.fc = nn.Linear(10, 7)

    def forward(self, x):
        x = self.t(self.d(self.c(x.permute(0, 3, 1, 2))))  # [B, 2, 16, 16]
        x = x.reshape(x.shape[0], 2, 16 * 16)[:, :, :16]  # [B, 2, 16]: 2 steps of 16
        y, _ = self.lstm(x)
        return self.fc(y)


def test_forward_flops_by_hand():
    with torch.device("meta"):
        m = Tiny()
    B = 2
    conv = 2 * B * 4 * 8 * 8 * 3 * 3 * 3
    dw = 2 * B * 4 * 8 * 8 * 3 * 3
    tconv = 2 * B * 4 * 8 * 8 * 2 * 2 * 2
    lstm = 2 * B * 2 * 2 * 4 * 5 * (16 + 5)
    fc = 2 * B * 2 * 10 * 7
    assert Y._forward_flops(m, (B, 8, 8, 3)) == conv + dw + tconv + lstm + fc


def test_rec_flops_scale_with_batch():
    rec = config("mobile-ch")["rec"]
    one = Y.forward_flops(rec, (1, 48, 320, 3))
    assert Y.forward_flops(rec, (8, 48, 320, 3)) == 8 * one
    # the projection alone: 80 steps of 96 -> 21060
    assert one > 2 * 80 * 96 * 21060


@pytest.mark.parametrize("name, part, shape, flops", [
    ("mobile-ch", "det", (8, 192, 960, 3), 13765008384),
    ("server-ch", "det", (8, 192, 960, 3), 329357721600),
    ("mobile-ch", "rec", (64, 48, 320, 3), 25975832576),
    ("server-ch", "rec", (64, 48, 320, 3), 25975832576),
])
def test_forward_flops_keep_their_integers(name, part, shape, flops):
    assert Y.forward_flops(config(name)[part], shape) == flops

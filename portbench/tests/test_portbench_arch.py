"""Each configuration's models are found by the kind its sections state
(``reference/arch/<kind>.py``): the reference's models equal those its
loaders build directly, a kind with no file is refused with the path looked
for, and a kind module that exists only in ``sys.modules`` serves the
reference and the FLOP count with no other file changed."""

import os
import sys
import types

import pytest
import torch
import torch.nn as nn

from _helpers import ROOT, config

import run
import yardstick as Y
from reference import arch
from reference import clip as C
from reference import models as M


def _direct(cfg):
    det, rec = cfg["det"], cfg["rec"]
    path = lambda p: os.path.join(ROOT, p)  # noqa: E731
    load_det = M.load_db_resnet if det["variant"] == "server" else M.load_ppocr_det
    return (load_det(path(det["weights"])),
            M.load_crnn(path(rec["weights"]), rec["num_classes"], rec["lstm_hidden_size"],
                        rec["backbone_scale"]))


@pytest.mark.parametrize("name", ["mobile-ch", "server-ch"])
def test_reference_models_equal_the_loaders(name):
    cfg = config(name)
    ref = C.Reference(cfg, "cpu")
    det, rec = _direct(cfg)
    g = torch.Generator().manual_seed(19)
    canvas = torch.rand((2, 64, 96, 3), generator=g) * 2 - 1
    crops = torch.rand((2, 48, 64, 3), generator=g) * 2 - 1
    with torch.no_grad():
        assert torch.equal(ref.det(canvas), det(canvas))
        assert torch.equal(ref.rec(crops), rec(crops))
    for a, b in ((ref.det, det), (ref.rec, rec)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_unknown_kind_names_the_path():
    cfg = config("mobile-ch")
    cfg["rec"] = dict(cfg["rec"], kind="no_such_kind")
    want = os.path.join(os.path.dirname(arch.__file__), "no_such_kind.py")
    with pytest.raises(arch.UnknownKind, match=want):
        C.Reference(cfg, "cpu")
    with pytest.raises(run.Failure, match=want):
        run.check_kinds(cfg)
    with pytest.raises(arch.UnknownKind, match=want):
        Y.forward_flops(cfg["rec"], (1, 48, 320, 3))


@pytest.mark.parametrize("kind", [None, "", "../models", "Crnn"])
def test_a_section_without_a_valid_kind_is_refused(kind):
    cfg = config("mobile-ch")
    cfg["det"] = {k: v for k, v in cfg["det"].items() if k != "kind"}
    if kind is not None:
        cfg["det"]["kind"] = kind
    with pytest.raises(run.Failure, match="kind"):
        run.check_kinds(cfg)


class _Toy(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.conv = nn.Conv2d(3, width, 1, bias=False)

    def forward(self, x):
        return self.conv(x.permute(0, 3, 1, 2))


@pytest.fixture
def injected(monkeypatch):
    mod = types.ModuleType("reference.arch.toy_kind")
    mod.loaded = []

    def build(section):
        return _Toy(section["width"])

    def load(path, section):
        mod.loaded.append(path)
        return build(section).eval()

    mod.build, mod.load = build, load
    mod.extra_flops = lambda section, shape: 1000 * shape[0]
    monkeypatch.setitem(sys.modules, "reference.arch.toy_kind", mod)
    return mod


def test_a_kind_injected_through_sys_modules_is_found(injected):
    assert not os.path.exists(os.path.join(os.path.dirname(arch.__file__), "toy_kind.py"))
    cfg = config("mobile-ch")
    cfg["det"] = dict(cfg["det"], kind="toy_kind", width=5, weights="toy/det.bin")
    cfg["rec"] = dict(cfg["rec"], kind="toy_kind", width=7, weights="toy/rec.bin")
    run.check_kinds(cfg)
    ref = C.Reference(cfg, "cpu")
    assert isinstance(ref.det, _Toy) and ref.det.conv.out_channels == 5
    assert isinstance(ref.rec, _Toy) and ref.rec.conv.out_channels == 7
    assert injected.loaded == [os.path.join(ROOT, "toy/det.bin"), os.path.join(ROOT, "toy/rec.bin")]
    # a 1x1 conv of 3 -> 7 channels on [2, 4, 6]: 2 x 2*4*6*7 x 3, and the kind's extra
    assert Y.forward_flops(cfg["rec"], (2, 4, 6, 3)) == 2 * (2 * 4 * 6 * 7) * 3 + 2000
    assert Y.forward_flops(cfg["det"], (1, 4, 6, 3)) == 2 * (4 * 6 * 5) * 3 + 1000

"""The mobile CRNN recognizer (MobileNetV3-small x ``backbone_scale``, two
BiLSTMs of ``lstm_hidden_size``, a CTC projection to ``num_classes``), its
layers in ``reference/models.py``."""

from .. import models as M


def _sizes(section):
    return section["num_classes"], section["lstm_hidden_size"], section["backbone_scale"]


def build(section):
    return M.CRNN(*_sizes(section))


def load(path, section):
    return M.load_crnn(path, *_sizes(section))


def extra_flops(section, shape):
    return 0

"""PP-OCRv3's mobile DB detector (MobileNetV3-large x0.5, RSEFPN 96), its
layers in ``reference/models.py``."""

from .. import models as M


def build(section):
    return M.PPOCRv3Det()


def load(path, section):
    return M.load_ppocr_det(path)


def extra_flops(section, shape):
    return 0

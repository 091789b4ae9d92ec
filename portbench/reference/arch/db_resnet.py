"""The DB-ResNet-50 server detector (bottlenecks 3-4-6-3, FPN 256), its
layers in ``reference/models.py``."""

from .. import models as M


def build(section):
    return M.DBResNet()


def load(path, section):
    return M.load_db_resnet(path)


def extra_flops(section, shape):
    return 0

"""Each model kind's reference, found by the ``kind`` that a configuration's
``det`` or ``rec`` section states: the module ``reference/arch/<kind>.py``,
which holds

- ``build(section) -> nn.Module``: the float32 model the section describes,
  built on the current default device (``meta`` included);
- ``load(path, section) -> nn.Module``: the same model with the weights of
  ``path``, read by the module itself;
- ``extra_flops(section, shape) -> int``: the operations of one forward on
  an NHWC input of ``shape`` that no convolution, dense layer or LSTM call
  covers (attention's score and value products), which
  ``yardstick.forward_flops`` adds to its count of those calls.

A new kind is a new file here and a configuration that names it. There is
no default kind: a section without one, or with one that has no file, is
refused with the path that was looked for.
"""

from __future__ import annotations

import importlib
import os
import re
import sys
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))


class UnknownKind(LookupError):
    """A configuration names a model kind that has no reference here."""


def of(section: dict) -> ModuleType:
    """The reference module of the section's ``kind``."""
    kind = section.get("kind")
    if not isinstance(kind, str) or not re.fullmatch(r"[a-z][a-z0-9_]*", kind):
        raise UnknownKind(f"a model section states no kind of reference/arch/<kind>.py: "
                          f"kind {kind!r}")
    name = f"{__name__}.{kind}"
    path = os.path.join(HERE, kind + ".py")
    if name not in sys.modules and not os.path.isfile(path):
        raise UnknownKind(f"no reference for model kind {kind!r}: {path} does not exist")
    return importlib.import_module(name)

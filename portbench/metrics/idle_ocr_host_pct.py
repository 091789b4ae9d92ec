"""Share of the profiled clip's wall time in which the device was idle
while the extractor's thread was in the OCR step or its host formatting
(``ocr.step``, ``ocr.format``): the device held back by the step's eager
host work and its waits."""

import recorder


def read(r):
    return recorder.idle_share_pct(r, ["ocr.step", "ocr.format"])

"""Share of the crops sent through the rec and K1 that held a detected box:
100 x the program's ``ocr.boxes`` counter over its ``ocr.crops`` counter
(every box slot of every frame of a chunk), summed over the window."""

import recorder


def read(r):
    crops, boxes = recorder.counter_sum("ocr.crops"), recorder.counter_sum("ocr.boxes")
    return 100.0 * boxes / crops if crops and boxes is not None else None

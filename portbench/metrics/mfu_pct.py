"""Operations of every det and rec forward of the window (counted from the
input shape of each forward, ``yardstick.forward_flops`` of the
configuration's det or rec section; a forward whose input has the rec's
height and width is the rec's) over the window's wall time and the bf16
dense peak, in percent. The profiled clip is left out of both."""

import yardstick


def read(r):
    det, rec = r["config"]["det"], r["config"]["rec"]
    rec_hw = (rec["image_height"], rec["image_width"])
    flops = 0
    for shape in r["spans_shapes"]("forward"):
        x = shape[0]
        flops += yardstick.forward_flops(rec if tuple(x[1:3]) == rec_hw else det, tuple(x))
    if not flops or not r["wall_s"]:
        return None
    return 100.0 * flops / (r["wall_s"] * yardstick.PEAK_BF16_FLOPS)

"""Operations of every det and rec forward of the window (counted from the
input shape of each forward, ``yardstick.forward_flops``) over the
window's wall time and the bf16 dense peak, in percent. The profiled clip
is left out of both."""

import yardstick


def read(r):
    cfg = r["config"]
    det = f"det:{cfg['det']['variant']}"
    rec = f"rec:{cfg['rec']['num_classes']}"
    rec_hw = (cfg["rec"]["image_height"], cfg["rec"]["image_width"])
    flops = 0
    for shape in r["spans_shapes"]("forward"):
        x = shape[0]
        kind = rec if tuple(x[1:3]) == rec_hw else det
        flops += yardstick.forward_flops(kind, tuple(x))
    if not flops or not r["wall_s"]:
        return None
    return 100.0 * flops / (r["wall_s"] * yardstick.PEAK_BF16_FLOPS)

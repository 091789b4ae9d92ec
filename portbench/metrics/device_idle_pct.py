"""Share of the profiled clip's wall time in which no op ran on the device:
100 - the union of device-op intervals over the slice."""

import devtrace


def read(r):
    bw = devtrace.busy_and_window_s(r["profile"])
    if bw is None or bw[1] <= 0:
        return None
    return 100.0 * (1.0 - bw[0] / bw[1])

"""Share of the profiled clip's wall time in which the device was idle
while the extractor's thread waited on the next uploaded frame batch (its
``feed.wait`` spans): the device held back by the frame path."""

import recorder


def read(r):
    return recorder.idle_share_pct(r, ["feed.wait"])

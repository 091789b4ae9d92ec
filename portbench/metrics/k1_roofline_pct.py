"""K1 against its memory roofline in the profiled clip: the bytes its
launches must move (``yardstick.k1_bytes``) over their device time and
3.35 TB/s, counting only launches whose device records all arrived."""

import roofline
import yardstick


def read(r):
    return roofline.share(r, "k1", r"ctc_", lambda s: yardstick.k1_bytes(*s[0][:3]))

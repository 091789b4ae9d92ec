"""User and system CPU seconds of the process and its children, summed over
the window's clips (the profiled one left out), per second of video
completed: the host's cores that the speed costs."""


def read(r):
    return r["cpu_s"] / r["video_s"] if r["video_s"] and r["cpu_s"] else None

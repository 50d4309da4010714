"""frames/s: frames whose disparities reached host memory inside the
window, over the window's seconds (host clock): all the work and all the
time of the window."""
UNIT = "frames/s"


def read(run):
    return run.frames_done / run.seconds

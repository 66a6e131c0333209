"""Stage-2 throughput: every frame of the videos the window ran, over all
the time it took (the video in progress at ``--seconds`` is finished)."""
UNIT = "frames/s"
SOURCE = "host_clock"


def read(run):
    return run.values.get("frames_per_s")

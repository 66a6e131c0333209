"""Kernel launches the host issued per frame in the traced slice (CUDA
runtime and driver launch calls in the trace's host activity)."""
UNIT = "launches/frame"
SOURCE = "device_trace"
LAYER = "infer.segmenter"
MOVES = "frames_per_s"


def read(run):
    if run.trace is None or not run.trace.launches:
        return None
    return run.trace.launches / run.counters["trace_frames"]

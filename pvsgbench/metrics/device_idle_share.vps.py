"""Share of the traced slice in which no operation ran on the device: one
less the union of the device's kernel, copy and fill intervals over the
slice."""
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "frames_per_s"


def read(run):
    if run.trace is None or not run.trace.devices() or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

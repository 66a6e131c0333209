"""Kernel B2's share of its roofline in the traced slice: the least time of
its launches (bytes, or its FP32 blend operations per query-pixel pair; the
data-dependent exact sigmoids are left out, so the bound is a lower one)
over their traced device time."""
from pvsgbench.drivers import vps

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "frames_per_s"
KERNELS = ("fusion_maps",)


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * vps.kernel_bounds(run)[1] / spent

"""Kernel B1's share of its roofline in the traced slice: the least time of
its three launches per batch (the larger of operations over the bfloat16
peak and bytes over 3.35 TB/s, from shapes) over their traced device time."""
from pvsgbench.drivers import vps

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "frames_per_s"
KERNELS = ("fpn_gemm", "fpn_conv3x3")


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * vps.kernel_bounds(run)[0] / spent

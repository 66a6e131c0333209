"""The whole serving step's share of the H100's bfloat16 peak for a Swin
configuration: the segmenter's FLOPs per frame, counted from the
configuration's shapes (``counts_swin.py``), times the window's frames per
second, over 989 TFLOP/s."""
from pvsgbench import counts, counts_swin

UNIT = "%"
SOURCE = "host_clock"
LAYER = "models"
MOVES = "frames_per_s"


def read(run):
    fps = run.values.get("frames_per_s")
    if not fps:
        return None
    flops = counts_swin.segmenter_flops_per_frame(run.config["model"],
                                                  run.workload["traffic"]["frame_hw"])
    return 100.0 * flops * fps / counts.PEAK_FLOPS["bfloat16"]

"""The backbone's share of its roofline in the traced slice: its FLOPs per
frame counted from the configuration's shapes (``counts_swin.py``: a Swin,
or ``counts.backbone_flops`` for a ResNet) over its device time per frame
(``backbone_ms_per_frame.vps``), over the H100's bfloat16 peak of 989
TFLOP/s."""
from pvsgbench import core, counts, counts_swin

UNIT = "%"
SOURCE = "program_span"
LAYER = "models"
MOVES = "frames_per_s"


def read(run):
    ms = core.load_module("metrics", "backbone_ms_per_frame.vps").read(run)
    if not ms:
        return None
    flops = counts_swin.backbone_flops_per_frame(run.config["model"],
                                                 run.workload["traffic"]["frame_hw"])
    return 100.0 * flops / (ms * 1e-3) / counts.PEAK_FLOPS["bfloat16"]

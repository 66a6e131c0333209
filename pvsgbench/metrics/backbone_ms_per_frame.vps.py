"""Device time of the segmenter's backbone per frame in the traced slice:
the program's counters ``segmenter.backbone_device_us`` (a CUDA event pair
on the forward's stream around the frames' normalization, zero pad and
backbone, in every forward under the profiler) over
``segmenter.backbone_frames``. None where the program keeps no such
counters."""
UNIT = "ms/frame"
SOURCE = "program_span"
LAYER = "models"
MOVES = "frames_per_s"


def counters() -> dict:
    """The program's recorder counters, {} where it has no recorder."""
    try:
        from openpvsg_torch.utils.profiling import RECORDER
    except ImportError:
        return {}
    return RECORDER.snapshot()["counters"]


def read(run):
    if run.trace is None:
        return None
    c = counters()
    us, frames = c.get("segmenter.backbone_device_us"), c.get("segmenter.backbone_frames")
    if not us or not frames:
        return None
    return us / 1e3 / frames

"""Host wall time inside the segmenter's two calls per batch
(``infer_windows_vps_async``, ``finish_windows_vps``: forward launches,
waiting for the device, stitch, fusion, fetch), per frame of the window."""
UNIT = "ms/frame"
SOURCE = "program_span"
LAYER = "infer.segmenter"
MOVES = "frames_per_s"


def read(run):
    c = run.counters
    if not c.get("window_frames"):
        return None
    return 1e3 * c["segmenter_s"] / c["window_frames"]

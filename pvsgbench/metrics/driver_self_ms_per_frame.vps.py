"""Wall time of ``run_query_tube_vps`` outside the segmenter's calls: tube
bookkeeping, RLE, ``masks.txt`` and the pickle, per frame of the window."""
UNIT = "ms/frame"
SOURCE = "program_span"
LAYER = "infer.stages"
MOVES = "frames_per_s"


def read(run):
    c = run.counters
    if not c.get("window_frames"):
        return None
    return 1e3 * (c["video_s"] - c["segmenter_s"]) / c["window_frames"]

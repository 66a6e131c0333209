"""Stage 3 CLI, after ``tools/prepare_rel_set.py`` (reference:
tools/prepare_rel_set.py and prepare_rel_set_dist.py): match each video's
predicted tubes to its GT tubes, translate the GT relations and join the
query features -> ``{work_dir}/{split}_save_qf/{vid}/relations.pickle``,
through ``infer/stages.py:run_rel_set``.

  python -m openpvsg_torch.tools.prepare_rel_set --data-dir data \\
      --anno-file data/pvsg.json --work-dir work_dirs --split train --jobs 8

Stage 3 runs on the host only. ``--jobs`` above 1 runs the videos in a pool
of that many processes, started by ``spawn`` (the parent initializes no
device before it starts them; the workers never touch one). A video whose
stage 3 raises is reported in the log, and the run goes on (the
reference's per-video isolation). The run ends with a ``summary:`` log
line: videos, the relation sets written, the failures, seconds and the
kernel launch counts (none).
"""
from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

from openpvsg_torch.tools.common import (base_parser, kernel_launches,
                                         load_config, log_summary,
                                         reject_unused_n_time, setup_logging)


def _one(task):
    vid, work_dir, anno_file, split, data_dir = task
    from openpvsg_torch.data.pvsg import PVSGRelationAnnotation
    from openpvsg_torch.infer.stages import run_rel_set

    anno = PVSGRelationAnnotation(anno_file, split)
    try:
        return vid, run_rel_set(vid, work_dir, anno, data_dir)
    except Exception as e:  # noqa: BLE001 — per-video isolation, as the
        # reference's swallow-and-print (prepare_rel_set_dist.py:40-42),
        # but the failure is reported in the log and the summary
        return vid, f"ERROR: {type(e).__name__}: {e}"


def main(argv=None):
    parser = base_parser("Build relations.pickle per video")
    parser.add_argument("--split", default="train")
    parser.add_argument("--videos", nargs="*", default=None)
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--skip-existing", action="store_true")
    args = parser.parse_args(argv)
    reject_unused_n_time(args)
    cfg = load_config(args)

    from openpvsg_torch.data.pvsg import PVSGRelationAnnotation

    work_dir = os.path.join(cfg.data.work_dir, f"{args.split}_save_qf")
    logger = setup_logging(work_dir, "prepare_rel_set")
    launches_before = kernel_launches()
    anno = PVSGRelationAnnotation(cfg.data.anno_file, args.split)
    videos = args.videos or [
        v for v in anno.split_video_ids
        if os.path.exists(os.path.join(work_dir, v, "quantitive", "masks.txt"))
    ]
    if args.skip_existing:
        videos = [v for v in videos if not os.path.exists(
            os.path.join(work_dir, v, "relations.pickle"))]
    logger.info(f"{len(videos)} videos, jobs={args.jobs}")

    tasks = [(v, work_dir, cfg.data.anno_file, args.split, cfg.data.data_dir)
             for v in videos]
    summary = {"videos": len(videos), "written": 0, "failed": [], "jobs": args.jobs}
    t0 = time.perf_counter()
    if args.jobs > 1:
        with ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_one, tasks))
    else:
        done = [_one(t) for t in tasks]
    for vid, out in done:
        logger.info(f"{vid}: {out}")
        if isinstance(out, str) and out.startswith("ERROR"):
            summary["failed"].append(vid)
        elif out:
            summary["written"] += 1
    summary.update(seconds=time.perf_counter() - t0,
                   launches=kernel_launches(since=launches_before))
    log_summary(logger, summary)
    return summary


if __name__ == "__main__":
    main()

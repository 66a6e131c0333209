"""Dataset bootstrap: md5-checked unzip of an archive already on disk, and
frame extraction from a video, after ``tools/unzip_and_extract.py``
(reference: tools/unzip_and_extract.py). It downloads nothing. Frames are
decoded by ffmpeg, which must be on the PATH for ``--video``.

  python -m openpvsg_torch.tools.unzip_and_extract --zip pvsg.zip \\
      --md5 <md5> --out data
  python -m openpvsg_torch.tools.unzip_and_extract --video v.mp4 \\
      --frames-out data/frames/v --fps 5

No device is involved: both steps run on the host.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import zipfile
from typing import Optional


def md5sum(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def unzip(zip_path: str, out_dir: str, expected_md5: Optional[str] = None):
    """Extract ``zip_path`` into ``out_dir``; with ``expected_md5`` the
    archive's md5 must match first, or this raises ValueError and writes
    nothing."""
    if expected_md5:
        actual = md5sum(zip_path)
        if actual != expected_md5:
            raise ValueError(f"{zip_path}: md5 {actual} != expected {expected_md5}")
    os.makedirs(out_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(out_dir)


def extract_frames(video_path: str, out_dir: str, fps: int = 5):
    """``out_dir/%04d.png`` from frame 0 at ``fps`` frames per second."""
    if not shutil.which("ffmpeg"):
        raise RuntimeError("ffmpeg not available for frame extraction")
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run([
        "ffmpeg", "-y", "-i", video_path, "-vf", f"fps={fps}",
        "-start_number", "0", os.path.join(out_dir, "%04d.png"),
    ], check=True)


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset bootstrap")
    p.add_argument("--zip", default=None)
    p.add_argument("--md5", default=None)
    p.add_argument("--out", default="./data")
    p.add_argument("--video", default=None)
    p.add_argument("--frames-out", default=None)
    p.add_argument("--fps", type=int, default=5)
    args = p.parse_args(argv)
    if args.zip:
        unzip(args.zip, args.out, args.md5)
        print(f"extracted {args.zip} -> {args.out}")
    if args.video:
        extract_frames(args.video, args.frames_out or args.out, args.fps)


if __name__ == "__main__":
    main()

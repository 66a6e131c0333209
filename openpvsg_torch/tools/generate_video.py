"""PNG frame sequence -> video, after ``tools/generate_video.py``
(reference: tools/generate_video.py, cv2 at 5 fps): an H.264 file by ffmpeg
when it is on the PATH, else an animated GIF written by PIL (imported only
then). No device is involved.

  python -m openpvsg_torch.tools.generate_video FRAMES_DIR out.mp4 --fps 5
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="frames -> video")
    p.add_argument("frames_dir")
    p.add_argument("out_path")
    p.add_argument("--fps", type=int, default=5)
    args = p.parse_args(argv)

    if shutil.which("ffmpeg"):
        subprocess.run([
            "ffmpeg", "-y", "-framerate", str(args.fps),
            "-pattern_type", "glob", "-i",
            os.path.join(args.frames_dir, "*.png"),
            "-c:v", "libx264", "-pix_fmt", "yuv420p", args.out_path,
        ], check=True)
        return
    from PIL import Image

    names = sorted(n for n in os.listdir(args.frames_dir) if n.endswith(".png"))
    if not names:
        sys.exit("no frames found")
    imgs = [Image.open(os.path.join(args.frames_dir, n)) for n in names]
    gif_path = args.out_path if args.out_path.endswith(".gif") \
        else args.out_path + ".gif"
    imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / args.fps), loop=0)
    print(f"ffmpeg unavailable; wrote {gif_path}")


if __name__ == "__main__":
    main()

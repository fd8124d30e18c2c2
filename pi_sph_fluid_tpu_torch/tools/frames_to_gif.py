"""Convert a FileSink capture (raw concatenated page-packed framebuffers,
``--display file:frames.bin``) into one looping animated GIF offline (port
of `tools/frames_to_gif.py`).

Record on the card headless (the file sink appends ~1 KB a frame and never
blocks the dispatch loop), then build the shareable artifact later:

    python -m pi_sph_fluid_tpu_torch.tools.frames_to_gif frames.bin demo.gif \\
        --rows 64 --cols 128

The conversion is numpy and the pure-stdlib encoder of io/display.GifSink,
on the host; ``--device`` is the tools' common flag (``cuda``, the default,
raises without a card; ``--device cpu`` for a machine without one).
``main`` returns the frame count and the GIF's size.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.display import GifSink
from ..utils.profiling import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="frames_to_gif", description=__doc__)
    ap.add_argument("frames_bin", help="FileSink capture (raw packed frames)")
    ap.add_argument("gif_out")
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=128)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--max-frames", type=int, default=1800,
                    help="longer captures auto-decimate 2x to stay bounded")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    _, kind = resolve_device(args.device, "frames_to_gif")

    frame_bytes = args.rows // 8 * args.cols
    raw = np.fromfile(args.frames_bin, np.uint8)
    if len(raw) == 0 or len(raw) % frame_bytes:
        raise SystemExit(f"{args.frames_bin}: {len(raw)} bytes is not a "
                         f"whole number of {args.rows}x{args.cols} frames "
                         f"({frame_bytes} B each) — check --rows/--cols")
    sink = GifSink(args.gif_out, args.rows, args.cols, scale=args.scale,
                   fps=args.fps, max_frames=args.max_frames)
    frames = raw.reshape(-1, frame_bytes)
    for frame in frames:
        sink.push(frame)
    sink.close()
    return dict(device=kind, frames_in=len(frames), frames_out=len(sink.frames),
                gif_bytes=os.path.getsize(args.gif_out))


if __name__ == "__main__":
    main()

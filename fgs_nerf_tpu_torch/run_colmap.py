"""Capture -> dataset preprocessing CLI (port of the repo's
``run_colmap.py``, same flags, stages, messages and exit codes).

Point it at a capture directory (or a video) and it produces a loadable
dataset — frame extraction, foreground masks, COLMAP pose estimation,
`poses_bounds.npy` (llff convention) and `cameras_sphere.npz` (IDR /
dtu convention).  Host code only: it takes no ``--device``.

    python -m fgs_nerf_tpu_torch.run_colmap \
        --custom_dataset_path /path/to/capture
    python -m fgs_nerf_tpu_torch.run_colmap --run_mode video \
        --video_path clip.mp4 --custom_dataset_path /path/to/out

Stages degrade gracefully in restricted environments: rembg masking is
skipped (with a notice) when rembg is not installed, and pose
estimation is skipped when the `colmap` binary is absent but a
pre-reconstructed `sparse/0` model exists (the conversion steps then
run on it directly).  The machine with the card has neither ``colmap``
nor ``cv2`` (video frames) nor ``rembg`` (masks): there a capture comes
with its ``sparse/0`` model.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from fgs_nerf_tpu_torch.data.colmap import (
    colmap_to_poses_bounds, extract_video_frames, run_colmap,
)
from fgs_nerf_tpu_torch.data.preprocess import colmap_to_idr, mask_with_rembg


def config_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument(
        "--custom_dataset_path", type=str, required=True,
        help="capture root: expects images/ inside; outputs are written "
        "here too",
    )
    p.add_argument(
        "--run_mode", type=str, default="images",
        choices=["images", "video"],
    )
    p.add_argument(
        "--match_type", type=str, default="exhaustive_matcher",
        choices=["exhaustive_matcher", "sequential_matcher"],
        help="COLMAP matcher (sequential suits video captures)",
    )
    # video mode
    p.add_argument("--video_path", type=str, default=None)
    p.add_argument(
        "--video_fps", type=float, default=2.0,
        help="frames per second to extract",
    )
    # toggles
    p.add_argument("--skip_masks", action="store_true",
                   help="skip rembg foreground masking")
    p.add_argument("--skip_colmap", action="store_true",
                   help="reuse an existing sparse/0 reconstruction")
    p.add_argument(
        "--radius_scale", type=float, default=3.0,
        help="cameras_sphere normalization radius scale",
    )
    return p


def main(argv=None) -> int:
    args = config_parser().parse_args(argv)
    root = args.custom_dataset_path
    image_dir = os.path.join(root, "images")

    if args.run_mode == "video":
        if not args.video_path:
            print("error: --run_mode video requires --video_path",
                  file=sys.stderr)
            return 2
        n = extract_video_frames(args.video_path, image_dir,
                                 fps=args.video_fps)
        print(f"extracted {n} frames -> {image_dir}")

    if not os.path.isdir(image_dir):
        print(f"error: no images/ directory under {root}", file=sys.stderr)
        return 2

    if not args.skip_masks:
        n = mask_with_rembg(image_dir, os.path.join(root, "mask"))
        if n is None:
            print("rembg not installed — skipping foreground masks "
                  "(datasets synthesize masks from brightness when absent)")
        else:
            print(f"wrote {n} masks -> {os.path.join(root, 'mask')}")

    sparse0 = os.path.join(root, "sparse", "0")
    if args.skip_colmap or (
        os.path.isdir(sparse0) and os.listdir(sparse0)
    ):
        if not os.path.isdir(sparse0):
            print("error: --skip_colmap but no sparse/0 model found",
                  file=sys.stderr)
            return 2
        print(f"using existing reconstruction {sparse0}")
        rows = colmap_to_poses_bounds(sparse0)
        pb = os.path.join(root, "poses_bounds.npy")
        np.save(pb, rows)
    else:
        pb = run_colmap(root, match_type=args.match_type)
    print(f"poses_bounds: {pb}")

    cs = colmap_to_idr(sparse0, root, radius_scale=args.radius_scale)
    print(f"cameras_sphere: {cs}")
    print("Dataset preprocess complete — load with dataset_type='llff' "
          "(poses_bounds) or the IDR-style loaders (cameras_sphere).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

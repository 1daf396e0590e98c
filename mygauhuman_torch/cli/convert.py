"""COLMAP conversion: raw images -> undistorted 3DGS scene layout
(a copy of the JAX package's cli/convert.py: subprocess and cv2 only).

Parity with the reference's stock converter (its convert.py, itself
derived from the MipNeRF-360 shell script): feature extraction ->
exhaustive matching -> mapper -> image_undistorter, then the sparse/0
directory shuffle and optional 1/2, 1/4, 1/8 image pyramids.

Differences from the reference (deliberate, not drift):
  * subprocess.run with argument lists instead of os.system string
    concatenation (no shell-quoting pitfalls, clear per-stage errors);
  * the --resize pyramid is computed in-process with cv2 INTER_AREA
    (the reference shells out to ImageMagick `mogrify -resize 50%`,
    convert.py:105); INTER_AREA is the box filter magick
    uses for downscales, and it removes the external dependency;
  * a missing `colmap` binary fails up front with a clear message instead
    of a cryptic non-zero exit mid-pipeline.

COLMAP itself is an external binary in both repos; this module is the
orchestration layer only. Human datasets (ZJU/MonoCap/DNA) never need it —
it exists for the generic-scene path (data/colmap_loader.py readers).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def _run(cmd: list[str], stage: str) -> None:
    print(f"[convert] {stage}: {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd)
    if proc.returncode != 0:
        sys.exit(f"[convert] {stage} failed with code {proc.returncode}")


def run_colmap(
    source_path: str,
    colmap: str = "colmap",
    camera: str = "OPENCV",
    use_gpu: bool = True,
    skip_matching: bool = False,
) -> None:
    """Run the COLMAP SfM + undistortion pipeline on source_path/input.

    Mirrors the reference's convert.py:31-88: distorted/ holds the raw SfM
    model; the undistorter writes ideal-pinhole images + sparse/ into
    source_path, and the model files are moved under sparse/0 where the
    dataset readers expect them (data/colmap_loader.py).
    """
    if shutil.which(colmap) is None:
        sys.exit(
            f"[convert] COLMAP executable {colmap!r} not found on PATH. "
            "Install COLMAP or pass --colmap_executable."
        )
    gpu = "1" if use_gpu else "0"
    if not skip_matching:
        os.makedirs(os.path.join(source_path, "distorted", "sparse"), exist_ok=True)
        db = os.path.join(source_path, "distorted", "database.db")
        _run([
            colmap, "feature_extractor",
            "--database_path", db,
            "--image_path", os.path.join(source_path, "input"),
            "--ImageReader.single_camera", "1",
            "--ImageReader.camera_model", camera,
            "--SiftExtraction.use_gpu", gpu,
        ], "feature extraction")
        _run([
            colmap, "exhaustive_matcher",
            "--database_path", db,
            "--SiftMatching.use_gpu", gpu,
        ], "feature matching")
        _run([
            colmap, "mapper",
            "--database_path", db,
            "--image_path", os.path.join(source_path, "input"),
            "--output_path", os.path.join(source_path, "distorted", "sparse"),
            "--Mapper.ba_global_function_tolerance=0.000001",
        ], "bundle adjustment")

    _run([
        colmap, "image_undistorter",
        "--image_path", os.path.join(source_path, "input"),
        "--input_path", os.path.join(source_path, "distorted", "sparse", "0"),
        "--output_path", source_path,
        "--output_type", "COLMAP",
    ], "image undistortion")

    # undistorter writes model files directly under sparse/; readers expect
    # sparse/0 (reference convert.py:80-88).
    sparse = os.path.join(source_path, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for name in os.listdir(sparse):
        if name == "0":
            continue
        shutil.move(os.path.join(sparse, name), os.path.join(sparse, "0", name))


def build_image_pyramid(source_path: str) -> None:
    """Write images_2 / images_4 / images_8 downscale pyramids in-process."""
    import cv2

    src_dir = os.path.join(source_path, "images")
    files = sorted(os.listdir(src_dir))
    for factor in (2, 4, 8):
        os.makedirs(os.path.join(source_path, f"images_{factor}"), exist_ok=True)
    for name in files:
        img = cv2.imread(os.path.join(src_dir, name), cv2.IMREAD_UNCHANGED)
        if img is None:
            print(f"[convert] skipping unreadable file {name}", flush=True)
            continue
        for factor in (2, 4, 8):
            # half-UP rounding (int(x + 0.5)), matching ImageMagick's
            # '-resize 50%' used by the reference convert.py — Python's
            # round() is half-to-even and yields off-by-one dims on odd
            # sizes (1001 -> 500 instead of 501)
            h = max(1, int(img.shape[0] / factor + 0.5))
            w = max(1, int(img.shape[1] / factor + 0.5))
            small = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
            cv2.imwrite(os.path.join(source_path, f"images_{factor}", name), small)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("COLMAP converter")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="")
    p.add_argument("--resize", action="store_true",
                   help="also write images_2/4/8 downscale pyramids")
    args = p.parse_args(argv)

    run_colmap(
        args.source_path,
        colmap=args.colmap_executable or "colmap",
        camera=args.camera,
        use_gpu=not args.no_gpu,
        skip_matching=args.skip_matching,
    )
    if args.resize:
        build_image_pyramid(args.source_path)
    print("[convert] done.")


if __name__ == "__main__":
    main()

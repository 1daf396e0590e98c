"""Batch benchmark entry point — the reference `full_eval.py` for the human
pipeline on the PyTorch port (port of cli/full_eval.py): trains, renders
and gathers the metrics of a list of scenes through the port's `cli.train`
and `cli.render`.

    python -m mygauhuman_torch.cli.full_eval --scenes <path> [<path> ...]
        [--smpl_model_path <model>] [--device cpu]

`--device` (default cuda: without a card it raises) is passed to both
CLIs, which pick the body from each source (an `.smc` capture loads the
SMPL-X model at `--smpl_model_path`); the summary
(`<output_root>/full_eval.json`) holds each scene's `results.json`
metrics, keyed by the scene's directory name.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="mygauhuman_torch full evaluation")
    p.add_argument("--scenes", nargs="+", required=True,
                   help="dataset paths (type auto-detected per path)")
    p.add_argument("--output_root", type=str, default="output/full_eval")
    p.add_argument("--iterations", type=int, default=1200)
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--smpl_model_path", type=str,
                   default="assets/SMPL_NEUTRAL_renderpeople.pkl")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from mygauhuman_torch.cli.render import main as render_main
    from mygauhuman_torch.cli.train import main as train_main

    body = ["--smpl_model_path", args.smpl_model_path, "--device", args.device]
    results = {}
    for scene in args.scenes:
        name = os.path.basename(scene.rstrip("/"))
        out_dir = os.path.join(args.output_root, name)
        if not args.skip_training:
            train_main([
                "-s", scene, "--model_path", out_dir,
                "--iterations", str(args.iterations),
                "--test_iterations", str(args.iterations),
                "--save_iterations", str(args.iterations),
            ] + body)
        if not args.skip_rendering:
            m = render_main(["-m", out_dir, "-s", scene,
                             "--iteration", str(args.iterations)] + body)
            m.pop("renders")          # the images, not metrics
            results[name] = m
    summary_path = os.path.join(args.output_root, "full_eval.json")
    os.makedirs(args.output_root, exist_ok=True)
    with open(summary_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(
        {k: {m: v[m] for m in ("psnr", "ssim", "lpips", "lpips_rand", "fps")
             if m in v}
         for k, v in results.items()}, indent=2))
    return results


if __name__ == "__main__":
    main()

"""Offline metrics CLI — the reference `metrics.py` (port of cli/metrics.py):
PSNR/SSIM/LPIPS over saved render directories -> results.json.

    python -m mygauhuman_torch.cli.metrics -r <renders> -g <gt> [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="mygauhuman_torch metrics")
    p.add_argument("--renders_dir", "-r", type=str, required=True)
    p.add_argument("--gt_dir", "-g", type=str, required=True)
    p.add_argument("--out", "-o", type=str, default="results.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from mygauhuman_torch.eval.metrics import evaluate_dirs

    result = evaluate_dirs(args.renders_dir, args.gt_dir, args.out, device=args.device)
    lkey = "lpips" if "lpips" in result else "lpips_rand"
    print(f"PSNR {result['psnr']:.2f}  SSIM {result['ssim']:.4f}  "
          f"{lkey.upper()} {result[lkey]:.4f}")
    return result


if __name__ == "__main__":
    main()

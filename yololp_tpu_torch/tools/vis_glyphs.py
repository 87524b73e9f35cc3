"""Render the authored CJK glyph contact sheet (data/glyphs.py) for visual
checks (mirrors tools/vis_glyphs.py of the JAX package). Host only.

Usage: python -m yololp_tpu_torch.tools.vis_glyphs [--out glyphs.png] [--cell 96]
"""

from __future__ import annotations

import argparse


def get_args_parser():
    p = argparse.ArgumentParser("glyph sheet")
    p.add_argument("--out", default="glyphs.png")
    p.add_argument("--cell", type=int, default=96)
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    import cv2

    from yololp_tpu_torch.data.glyphs import glyph_sheet
    from yololp_tpu_torch.data.vocab import PRO_NAMES

    sheet = 255 - glyph_sheet(PRO_NAMES + ["警", "学"], cell=args.cell)
    cv2.imwrite(args.out, sheet)
    print(f"wrote {args.out} ({sheet.shape[1]}x{sheet.shape[0]})")


if __name__ == "__main__":
    main()

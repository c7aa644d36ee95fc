"""Gradient paints demo: a card with a linear-gradient fill, a radial
glow and gradient text, written to PNG.

Exercises the paint extension (renderer.LinearGradient /
RadialGradient — the reference's color cover is solid-only,
shaders.wgsl:304-309).

Usage: python examples/gradients.py [--size WxH] [--out PATH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from contrast_renderer.path import Path  # noqa: E402
from contrast_renderer.renderer import (  # noqa: E402
    Configuration,
    DrawCommand,
    LinearGradient,
    RadialGradient,
    RenderOperation,
    Renderer,
    Shape,
)
from contrast_renderer.utils.png import write_png  # noqa: E402


def stencil_color(shape, transform, color):
    return [
        DrawCommand(RenderOperation.STENCIL, shape, transform),
        DrawCommand(RenderOperation.COLOR, shape, transform, color=color),
    ]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="480x270")
    parser.add_argument("--out", default="/tmp/gradients.png")
    parser.add_argument("--no-text", action="store_true")
    args = parser.parse_args()
    width, height = (int(x) for x in args.size.split("x"))

    t = np.diag(
        [2.0 / width, 2.0 / height, 1.0, 1.0]
    ).astype(np.float32)
    t[0, 3] = -1.0
    t[1, 3] = -1.0

    cx, cy = width / 2, height / 2
    card = Shape(
        [Path.from_rounded_rect((cx, cy), (0.42 * width, 0.38 * height),
                                0.08 * height)]
    )
    glow = Shape([Path.from_circle((0.72 * width, 0.62 * height),
                                   0.28 * height)])

    commands = stencil_color(
        card,
        t,
        LinearGradient(
            start=(cx - 0.42 * width, cy + 0.38 * height),
            end=(cx + 0.42 * width, cy - 0.38 * height),
            stops=(
                (0.0, (0.08, 0.12, 0.35, 1.0)),
                (0.55, (0.25, 0.10, 0.45, 1.0)),
                (1.0, (0.62, 0.18, 0.35, 1.0)),
            ),
        ),
    ) + stencil_color(
        glow,
        t,
        RadialGradient(
            center=(0.72 * width, 0.62 * height),
            edge=(width, 0.62 * height),
            color0=(1.0, 0.85, 0.3, 0.9),
            color1=(1.0, 0.85, 0.3, 0.0),
        ),
    )

    if not args.no_text:
        from contrast_renderer.assets import load_default_font
        from contrast_renderer.text import (
            Alignment,
            Layout,
            Orientation,
            paths_of_text,
        )

        glyphs = paths_of_text(
            load_default_font().face,
            Layout(
                size=0.16 * height,
                orientation=Orientation.LEFT_TO_RIGHT,
                major_alignment=Alignment.CENTER,
                minor_alignment=Alignment.CENTER,
            ),
            "Contrast",
        )
        from contrast_renderer.utils import ga2d

        center = ga2d.translate2d(np.array([cx, cy]))
        glyphs = [g.transform(1.0, center) for g in glyphs]
        text = Shape(glyphs)
        commands += stencil_color(
            text,
            t,
            LinearGradient(
                start=(cx - 0.3 * width, cy),
                end=(cx + 0.3 * width, cy),
                color0=(1.0, 1.0, 1.0, 1.0),
                color1=(0.6, 0.9, 1.0, 1.0),
            ),
        )

    renderer = Renderer(Configuration(), width, height)
    image = renderer.render(
        commands, background=(1.0, 1.0, 1.0, 1.0), as_uint8=True
    )
    write_png(args.out, image)
    print(f"wrote {args.out} ({width}x{height})")


if __name__ == "__main__":
    main()

"""Render every renderer on a synthetic scene and write a montage.

Mirrors ``examples/render_demo.py``: a 48³ blobs volume (seed 3) under
``gray_ramp(alpha_scale=1.0)``, each of the eight renderers through
``Renderer.render_progressive`` (32 frames for MCS and MCM, 4 for the
others, ``seed0=1``) at 192², the Reinhard tone mapper (K2 on the card),
and a 4 × 2 montage in the renderers' sorted order.

Run (the card):  python -m vpt_tpu_torch.examples.render_demo
On the CPU:      python -m vpt_tpu_torch.examples.render_demo --platform cpu

The montage goes to ``build/render_demo_torch.png`` (git-ignored) unless
``--out`` names another file.  :func:`main` parses the flags;
:func:`render_panels` takes the sizes.
"""

from __future__ import annotations

import argparse

import numpy as np

#: frames a renderer accumulates (the Monte-Carlo ones more)
FRAMES = {"mcs": 32, "mcm": 32}


def demo_scene(grid: int = 48, device=None):
    """The demo's scene: a ``grid``³ blobs volume (seed 3) under
    ``gray_ramp(alpha_scale=1.0)``, on ``device`` (default: the card)."""
    from .. import transfer, volume
    from ..renderers import make_scene

    return make_scene(volume.blobs_volume(grid, seed=3, device=device),
                      transfer.gray_ramp(alpha_scale=1.0, device=device),
                      device=device)


def render_images(scene, resolution: int = 192,
                  verbose: bool = True) -> dict:
    """{renderer key: its HDR (H, W, 4) image from
    ``render_progressive``} for every renderer on ``scene``."""
    from ..renderers import factory, make_renderer

    images = {}
    for key in sorted(factory.MODULES):
        r = make_renderer(key, height=resolution, width=resolution)
        images[key] = r.render_progressive(scene, frames=FRAMES.get(key, 4),
                                           seed0=1)
        if verbose:
            print(f"{key} done")
    return images


def render_panels(resolution: int = 192, grid: int = 48, device=None,
                  verbose: bool = True) -> dict:
    """{renderer key: its tone-mapped (H, W, 3) float32 image, rows
    bottom-up} for every renderer, on ``device`` (default: the card)."""
    from .. import tonemap

    mapper = tonemap.ToneMapper("reinhard")
    images = render_images(demo_scene(grid, device), resolution, verbose)
    return {key: np.clip(mapper(img).detach().cpu().numpy()[..., :3], 0, 1)
            for key, img in images.items()}


def montage(panels: dict) -> np.ndarray:
    """The (2H, 4W, 3) sheet, rows top-down: the first four renderers in
    sorted order on top, each panel flipped upright."""
    upright = [panels[k][::-1] for k in sorted(panels)]
    return np.concatenate([np.concatenate(upright[:4], axis=1),
                           np.concatenate(upright[4:], axis=1)], axis=0)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--out", default="build/render_demo_torch.png")
    ap.add_argument("--resolution", type=int, default=192)
    return ap


def main(argv=None):
    from ..io.image import write_png

    args = build_parser().parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    sheet = montage(render_panels(args.resolution, device=device))
    write_png(args.out, sheet, flip=False)
    print(f"wrote {args.out}")
    return sheet


if __name__ == "__main__":
    main()

"""Inverse isosurface rendering: recover geometry from a depth image.

Mirrors ``examples/depth_fit_demo.py`` (BASELINE config 1 end to end):
render a target depth map of a ground-truth sphere with the
differentiable ISO renderer (``renderers/diff_iso``), then optimize a
dimmed copy (0.6×) so that its isosurface reproduces that depth, the
gradients flowing through the soft first-crossing distribution.  Adam at
0.05 (``torch.optim.Adam`` in place of ``optax.adam``), the volume clipped
to [0, 1] after each step; the depth MSE must fall more than 5×.

The scene is built with ``pack=False``, as ``vpt_tpu``'s demo builds it:
on the card its samplers read the unpacked volume, and its kernels the
float32 corner tables ``make_scene`` gives it.

Run (the card):  python -m vpt_tpu_torch.examples.depth_fit_demo
On the CPU:      python -m vpt_tpu_torch.examples.depth_fit_demo --platform cpu

:func:`main` parses the flags; :func:`run` takes the sizes.
"""

from __future__ import annotations

import argparse

import torch


def run(grid: int = 24, resolution: int = 48, steps: int = 60, device=None,
        verbose: bool = True, check: bool = True):
    """Fit and return ``(l0, l1, losses)``: the depth MSE before and after,
    and after each logged step (every 10th)."""
    from .. import transfer, volume
    from ..renderers import diff_iso, make_scene

    h = w = resolution
    params = diff_iso.Params(isovalue=0.4, tau=0.03, steps=64)
    truth = volume.sphere_volume(grid, device=device).data
    scene = make_scene(truth, transfer.gray_ramp(alpha_scale=1.0,
                                                 device=truth.device),
                       pack=False, device=truth.device)
    with torch.no_grad():
        target = diff_iso.render(scene, params, h, w)["depth"]

    def loss_of(v):
        return diff_iso.depth_loss(v, scene, params, target, h, w)

    # start from a dimmed copy
    guess = (truth * 0.6).requires_grad_(True)
    opt = torch.optim.Adam([guess], lr=0.05)
    with torch.no_grad():
        l0 = float(loss_of(guess))
    logged = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss_of(guess).backward()
        opt.step()
        with torch.no_grad():
            guess.clamp_(0.0, 1.0)
            if i % 10 == 0:
                logged.append(float(loss_of(guess)))
                if verbose:
                    print(f"step {i:3d}  depth MSE {logged[-1]:.6f}")
    with torch.no_grad():
        l1 = float(loss_of(guess))
    if verbose:
        print(f"depth MSE: {l0:.6f} -> {l1:.6f}  "
              f"({l0 / max(l1, 1e-12):.1f}x)")
    if check:
        assert l1 < l0 * 0.2, "optimization should reduce depth error >5x"
    return l0, l1, logged


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu, or the card (default)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(device="cpu" if args.platform == "cpu" else None)


if __name__ == "__main__":
    main()

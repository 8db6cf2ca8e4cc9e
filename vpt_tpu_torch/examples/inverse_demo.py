"""Inverse rendering demo: reconstruct a volume from three orbit views.

Mirrors ``examples/inverse_demo.py``: a ``grid``³ blobs volume (seed 9)
rendered by the differentiable EAM frame (``train.render_eam``, 32
slices, no jitter) at 64² from three yaws of an orbit
(``runtime.animators.OrbitCameraAnimator``), then ``train.fit`` (Adam,
learning rate 0.1, ``torch.optim.Adam`` in place of ``optax.adam``) from a
flat 0.2 volume over the three views.  Prints the final loss and the mean
voxel error.

Run (the card):  python -m vpt_tpu_torch.examples.inverse_demo
On the CPU:      python -m vpt_tpu_torch.examples.inverse_demo --platform cpu

:func:`main` parses the flags; :func:`run` takes the sizes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def orbit_views(count: int = 3):
    """The camera matrices (mvp_inverse, model_view, projection) of
    ``count`` yaws evenly spaced around the default camera's orbit."""
    from ..runtime.animators import OrbitCameraAnimator
    from ..scene import CameraState, default_camera

    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    views = []
    for yaw in np.linspace(0, 2 * np.pi, count + 1)[:-1]:
        orbit.yaw = float(yaw)
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        views.append((cs.mvp_inverse, cs.model_view, cs.projection))
    return views


def run(grid: int = 16, steps: int = 150, resolution: int = 64,
        device=None, verbose: bool = True):
    """Fit and return ``(volume, losses, mean voxel error)``."""
    from .. import transfer, volume
    from ..renderers import eam
    from ..train import fit, render_eam
    from ..utils import resolve_device

    device = resolve_device(device)
    tf = transfer.gray_ramp(alpha_scale=1.0, device=device)
    params = eam.Params(slices=32, random=False)
    truth = volume.blobs_volume(grid, seed=9, device=device)
    views = [tuple(m.to(device) for m in v) for v in orbit_views()]
    with torch.no_grad():
        targets = [render_eam(truth.data, tf, mats, params, np.float32(0.0),
                              resolution, resolution) for mats in views]
    init = torch.full((grid,) * 3 + (1,), 0.2, dtype=torch.float32,
                      device=device)
    vol, _, losses = fit(targets, views, init, tf, steps=steps,
                         learning_rate=0.1, params=params, verbose=verbose)
    err = float(torch.mean(torch.abs(vol - truth.data)))
    if verbose:
        print(f"final loss {losses[-1]:.2e}; mean voxel error {err:.4f}")
    return vol, losses, err


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(args.grid, args.steps,
               device="cpu" if args.platform == "cpu" else None)


if __name__ == "__main__":
    main()

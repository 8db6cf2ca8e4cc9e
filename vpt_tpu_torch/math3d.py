"""Small 3D math (mat4 / quat / vec3) in PyTorch, float32.

Mirrors the subset of ``vpt_tpu/math3d.py`` that the scene graph needs.
Matrices are row-major and applied as ``M @ v`` with ``v`` a column vector,
the mathematical convention of gl-matrix.

Camera math must stay exact float32: TF32 products corrupt the near/far-plane
terms and give NaN rays.  :func:`matmul` and :func:`invert` therefore switch
TF32 off for CUDA matrix products and cuDNN before they run
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), and :func:`apply_mat4` is an
elementwise sum in a fixed left-to-right order.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def _exact_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def identity(device="cpu"):
    return torch.eye(4, dtype=_F32, device=device)


def perspective(fovy, aspect, near, far, device="cpu"):
    """OpenGL perspective projection (gl-matrix mat4.perspective)."""
    f = 1.0 / torch.tan(torch.tensor(fovy, dtype=_F32, device=device) / 2.0)
    nf = 1.0 / (near - far)
    m = torch.zeros(4, 4, dtype=_F32, device=device)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) * nf
    m[2, 3] = 2.0 * far * near * nf
    m[3, 2] = -1.0
    return m


def quat_identity(device="cpu"):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=_F32, device=device)


def mat4_from_quat(q):
    x, y, z, w = q[0], q[1], q[2], q[3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    one = torch.ones((), dtype=_F32, device=q.device)
    zero = torch.zeros((), dtype=_F32, device=q.device)
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy, zero]),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx, zero]),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy), zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def compose_trs(rotation_quat, translation_vec, scale_vec):
    """gl-matrix mat4.fromRotationTranslationScale."""
    m = mat4_from_quat(rotation_quat).clone()
    m[:3, :3] = m[:3, :3] * scale_vec[None, :]
    m[:3, 3] = translation_vec
    return m


def matmul(a, b):
    """Small-matrix product at full float32 precision (TF32 off)."""
    _exact_float32()
    return torch.matmul(a, b)


def invert(m):
    _exact_float32()
    return torch.linalg.inv(m).to(_F32)


def apply_mat4(m, v4):
    """``v4 @ m.T`` as an elementwise float32 sum, left to right
    (vpt_tpu/math3d.py:152-156)."""
    return (v4[..., 0:1] * m[:, 0] + v4[..., 1:2] * m[:, 1]
            + v4[..., 2:3] * m[:, 2] + v4[..., 3:4] * m[:, 3])


def transform_point(m, p):
    """Apply a mat4 to (..., 3) points (w = 1) and dehomogenise
    (vpt_tpu/math3d.py:162-170)."""
    p = torch.as_tensor(p, dtype=_F32, device=m.device)
    ph = torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=_F32,
                                  device=m.device)], dim=-1)
    out = apply_mat4(m, ph)
    return out[..., :3] / out[..., 3:4]

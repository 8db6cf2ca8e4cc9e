"""Small 3D math (mat4 / quat / vec3) in PyTorch, float32.

Mirrors ``vpt_tpu/math3d.py``: the vec3 helpers, the mat4 constructors, the
quaternion helpers after gl-matrix 3.4.1 and ``look_at``.  Arguments may
be numbers, sequences, numpy arrays or tensors; results are float32 tensors
on the argument's device (the CPU for anything but a tensor).  Matrices are
row-major and applied as ``M @ v`` with ``v`` a column vector,
the mathematical convention of gl-matrix.

Camera math must stay exact float32: TF32 products corrupt the near/far-plane
terms and give NaN rays.  :func:`matmul` therefore switches TF32 off for
CUDA matrix products and cuDNN before it runs
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), :func:`invert` runs LAPACK's
float32 LU on the host, as ``vpt_tpu`` does, and :func:`apply_mat4` is an
elementwise sum in a fixed left-to-right order.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


def _exact_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(x):
    return torch.as_tensor(x, dtype=_F32)


def vec3(x, y=None, z=None):
    if y is None:
        return _f32(x)
    return torch.tensor([x, y, z], dtype=_F32)


def normalize(v, eps=1e-12):
    return v / torch.sqrt(torch.clamp(dot(v, v)[..., None], min=eps))


def cross(a, b):
    return torch.linalg.cross(_f32(a), _f32(b))


def dot(a, b):
    """The sum over the last axis of ``a·b``, left to right."""
    p = _f32(a) * _f32(b)
    out = p[..., 0]
    for i in range(1, p.shape[-1]):
        out = out + p[..., i]
    return out


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


def translation(t):
    """Translation matrix (gl-matrix mat4.fromTranslation)."""
    t = _f32(t)
    m = torch.eye(4, dtype=_F32, device=t.device)
    m[:3, 3] = t
    return m


def scaling(s):
    s = _f32(s)
    return torch.diag(torch.cat([s, torch.ones(1, dtype=_F32,
                                                device=s.device)]))


def quat_identity(device="cpu"):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=_F32, device=device)


def quat_from_axis_angle(axis, angle):
    axis = normalize(_f32(axis))
    half = torch.as_tensor(angle, dtype=_F32, device=axis.device) / 2.0
    return torch.cat([axis * torch.sin(half), torch.cos(half)[None]])


def quat_multiply(a, b):
    """Hamilton product a*b with (x, y, z, w) storage (gl-matrix order)."""
    ax, ay, az, aw = _f32(a)
    bx, by, bz, bw = _f32(b)
    return torch.stack([
        ax * bw + aw * bx + ay * bz - az * by,
        ay * bw + aw * by + az * bx - ax * bz,
        az * bw + aw * bz + ax * by - ay * bx,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def quat_normalize(q):
    q = _f32(q)
    return q / torch.sqrt(torch.clamp(dot(q, q), min=1e-20))


def quat_invert(q):
    q = _f32(q)
    conj = torch.stack([-q[0], -q[1], -q[2], q[3]])
    return conj / torch.clamp(dot(q, q), min=1e-20)


def quat_from_euler(x_deg, y_deg, z_deg):
    """gl-matrix quat.fromEuler (degrees, ZYX application order)."""
    d2r = torch.tensor(np.pi / 360.0, dtype=_F32)    # half-angle in radians
    x, y, z = (_f32(v) * d2r for v in (x_deg, y_deg, z_deg))
    sx, cx = torch.sin(x), torch.cos(x)
    sy, cy = torch.sin(y), torch.cos(y)
    sz, cz = torch.sin(z), torch.cos(z)
    return torch.stack([
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz,
    ])


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
    """The inverse of a (4, 4) matrix as ``vpt_tpu`` takes it on the CPU:
    LAPACK's LU with partial pivoting in float32 (``getrf``), then the two
    triangular solves of the identity (``getrs``), through scipy's LAPACK,
    which jaxlib calls too.  On the host, whatever ``m``'s device; the
    result goes back to it."""
    from scipy.linalg import lu_factor, lu_solve

    a = m.detach().cpu().numpy().astype(np.float32)
    inv = lu_solve(lu_factor(a), np.eye(a.shape[0], dtype=np.float32))
    return torch.from_numpy(inv.astype(np.float32)).to(m.device)


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


def transform_homogeneous(m, p4):
    """Apply a mat4 to homogeneous (..., 4) vectors."""
    return apply_mat4(m, torch.as_tensor(p4, dtype=_F32, device=m.device))


def look_at(eye, center, up):
    """View matrix (gl-matrix mat4.lookAt)."""
    eye = _f32(eye)
    f = normalize(_f32(center) - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    return torch.stack([
        torch.cat([s, -dot(s, eye)[None]]),
        torch.cat([u, -dot(u, eye)[None]]),
        torch.cat([-f, dot(f, eye)[None]]),
        torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=_F32, device=eye.device),
    ])

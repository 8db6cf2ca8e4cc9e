"""Camera animators: orbit navigation and parametric paths.

Mirrors ``vpt_tpu/runtime/animators.py`` with the same arithmetic: numpy
float64 angles and float32 vectors, float32 quaternions from ``math3d``.

Counterparts of the reference's ``src/js/animators/``:
- :class:`OrbitCameraAnimator` — yaw/pitch orbit around a focus point with
  pan, exponential zoom, and WASD-style fly moves
  (OrbitCameraAnimator.js:78-160), driven by explicit method calls instead
  of DOM pointer events;
- :class:`CircleAnimator` — parametric circular path ``update(t)`` used for
  animation recording (CircleAnimator.js:17-40).
"""

from __future__ import annotations

import numpy as np

from .. import math3d as m4
from ..scene import Node


class OrbitCameraAnimator:
    """Orbit the camera node around ``focus``; angles in radians."""

    def __init__(self, camera: Node, focus=(0.0, 0.0, 0.0),
                 rotation_speed: float = 2.0, translation_speed: float = 1.0,
                 zoom_speed: float = 0.001):
        self.camera = camera
        self.focus = np.asarray(focus, np.float32)
        self.rotation_speed = rotation_speed
        self.translation_speed = translation_speed
        self.zoom_speed = zoom_speed
        # spherical state derived from the camera's current pose
        offset = np.asarray(camera.transform.local_translation) - self.focus
        self.distance = float(np.linalg.norm(offset))
        self.yaw = float(np.arctan2(offset[0], offset[2]))
        self.pitch = float(np.arcsin(np.clip(
            offset[1] / max(self.distance, 1e-9), -1, 1)))
        self.roll = 0.0
        self._update_camera()

    def rotate(self, dx: float, dy: float):
        """Pointer-drag rotate (OrbitCameraAnimator.js:122-136)."""
        self.yaw -= dx * self.rotation_speed
        self.pitch = float(np.clip(self.pitch + dy * self.rotation_speed,
                                   -np.pi / 2 + 1e-3, np.pi / 2 - 1e-3))
        self._update_camera()

    def pan(self, dx: float, dy: float):
        """Translate the focus in the camera plane."""
        right, up, _ = self._basis()
        self.focus = self.focus + (-dx * right + dy * up) \
            * self.translation_speed * self.distance
        self._update_camera()

    def zoom(self, wheel: float):
        """Exponential wheel zoom (OrbitCameraAnimator.js:145-152)."""
        self.distance *= np.exp(wheel * self.zoom_speed * 1000.0)
        self.distance = float(np.clip(self.distance, 1e-3, 1e3))
        self._update_camera()

    def fly(self, forward: float = 0.0, strafe: float = 0.0,
            lift: float = 0.0):
        """WASD-style focus translation along the view basis
        (OrbitCameraAnimator.js:130-160)."""
        right, up, back = self._basis()
        move = (strafe * right + lift * up - forward * back) \
            * self.translation_speed
        self.focus = self.focus + move
        self._update_camera()

    def roll_by(self, angle: float):
        """Rotate the camera about the view axis (keeps focus/eye)."""
        self.roll = float(self.roll + angle)
        self._update_camera()

    def _basis(self):
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        back = np.array([sy * cp, sp, cy * cp], np.float32)  # camera→eye dir
        right = np.array([cy, 0.0, -sy], np.float32)
        up = np.cross(back, right)
        return right, up.astype(np.float32), back

    def _update_camera(self):
        _, _, back = self._basis()
        eye = self.focus + back * self.distance
        t = self.camera.transform
        # look toward the focus: rotation = yaw about y then pitch about x
        qy = m4.quat_from_axis_angle(np.array([0.0, 1.0, 0.0]), self.yaw)
        qx = m4.quat_from_axis_angle(np.array([1.0, 0.0, 0.0]), -self.pitch)
        rot = m4.quat_multiply(qy, qx)
        if getattr(self, "roll", 0.0):
            qz = m4.quat_from_axis_angle(np.array([0.0, 0.0, 1.0]),
                                         self.roll)
            rot = m4.quat_multiply(rot, qz)
        t.local_rotation = rot
        t.local_translation = eye.astype(np.float32)


class CircleAnimator:
    """Circular path around ``center`` with given radius/frequency
    (CircleAnimator.js:17-40); ``update(t)`` with t in seconds."""

    def __init__(self, node: Node, center=(0.0, 0.0, 2.0),
                 direction=(0.0, 0.0, 1.0), radius: float = 0.01,
                 frequency: float = 1.0):
        self.node = node
        self.center = np.asarray(center, np.float32)
        d = np.asarray(direction, np.float32)
        self.direction = d / np.linalg.norm(d)
        self.radius = radius
        self.frequency = frequency
        # orthonormal basis of the circle plane
        helper = np.array([1.0, 0.0, 0.0], np.float32)
        if abs(self.direction @ helper) > 0.9:
            helper = np.array([0.0, 1.0, 0.0], np.float32)
        self.u = np.cross(self.direction, helper)
        self.u /= np.linalg.norm(self.u)
        self.v = np.cross(self.direction, self.u)

    def update(self, t: float):
        angle = 2.0 * np.pi * self.frequency * t
        pos = self.center + self.radius * (
            np.cos(angle) * self.u + np.sin(angle) * self.v)
        self.node.transform.local_translation = pos.astype(np.float32)

"""Scene graph: nodes, TRS transforms, perspective camera.

Mirrors ``vpt_tpu/scene.py`` without the traversal helpers: ``Transform``,
``Node``, ``PerspectiveCamera``, ``default_camera``, ``CENTER_MATRIX``,
``mvp_inverse`` and ``CameraState.from_nodes``.  Camera math runs on the
CPU in float32 (see ``math3d``); ``make_scene`` moves the three matrices to
the render device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from . import math3d as m4


class Transform:
    """TRS transform with a parent chain; setting a local property calls the
    registered change listeners."""

    def __init__(self, node: "Optional[Node]" = None):
        self.node = node
        self._rotation = m4.quat_identity()
        self._translation = torch.zeros(3, dtype=torch.float32)
        self._scale = torch.ones(3, dtype=torch.float32)
        self._listeners: List[Callable[[], None]] = []

    def add_change_listener(self, fn: Callable[[], None]):
        self._listeners.append(fn)

    def _changed(self):
        for fn in self._listeners:
            fn()

    @property
    def local_rotation(self):
        return self._rotation

    @local_rotation.setter
    def local_rotation(self, q):
        self._rotation = torch.as_tensor(q, dtype=torch.float32)
        self._changed()

    @property
    def local_translation(self):
        return self._translation

    @local_translation.setter
    def local_translation(self, t):
        self._translation = torch.as_tensor(t, dtype=torch.float32)
        self._changed()

    @property
    def local_scale(self):
        return self._scale

    @local_scale.setter
    def local_scale(self, s):
        self._scale = torch.as_tensor(s, dtype=torch.float32)
        self._changed()

    @property
    def local_matrix(self):
        return m4.compose_trs(self._rotation, self._translation, self._scale)

    @property
    def global_matrix(self):
        if self.node is not None and self.node.parent is not None:
            return m4.matmul(self.node.parent.transform.global_matrix,
                             self.local_matrix)
        return self.local_matrix

    @property
    def inverse_global_matrix(self):
        return m4.invert(self.global_matrix)


class Component:
    def __init__(self, node: "Node"):
        self.node = node


class Node:
    """Scene-graph node: children, traversal, component lookup."""

    def __init__(self):
        self.parent: Optional[Node] = None
        self.children: List[Node] = []
        self.components: List[Component] = []
        self.transform = Transform(self)

    def add_child(self, child: "Node"):
        if child.parent is not None:
            child.parent.remove_child(child)
        child.parent = self
        self.children.append(child)

    def remove_child(self, child: "Node"):
        if child in self.children:
            self.children.remove(child)
            child.parent = None

    def traverse(self, before=None, after=None):
        """Depth first: ``before(node)`` on the way down, ``after(node)``
        on the way up (Node.js:14-44)."""
        if before:
            before(self)
        for child in self.children:
            child.traverse(before, after)
        if after:
            after(self)

    def get_component(self, cls):
        for comp in self.components:
            if isinstance(comp, cls):
                return comp
        return None


class PerspectiveCamera(Component):
    """fovy/aspect/near/far → projection matrix (reference defaults)."""

    def __init__(self, node: Node, fovy: float = 1.0, aspect: float = 1.0,
                 near: float = 0.1, far: float = 100.0):
        super().__init__(node)
        self.fovy = fovy
        self.aspect = aspect
        self.near = near
        self.far = far

    @property
    def projection_matrix(self):
        return m4.perspective(self.fovy, self.aspect, self.near, self.far)


def default_camera(translation=(0.0, 0.0, 2.0), fovy: float = 1.0) -> Node:
    """Camera node at [0, 0, 2], as the reference context places it."""
    node = Node()
    node.transform.local_translation = torch.tensor(translation,
                                                    dtype=torch.float32)
    node.components.append(PerspectiveCamera(node, fovy=fovy))
    return node


CENTER_MATRIX = np.array([
    [1, 0, 0, -0.5],
    [0, 1, 0, -0.5],
    [0, 0, 1, -0.5],
    [0, 0, 0, 1],
], dtype=np.float32)


def model_view_matrix(camera: Node, volume_transform: Optional[Transform]):
    """``V @ M @ center(-0.5)``: texture space to view space."""
    model = volume_transform.global_matrix if volume_transform is not None \
        else m4.identity()
    view = camera.transform.inverse_global_matrix
    return m4.matmul(m4.matmul(view, model), torch.from_numpy(CENTER_MATRIX))


def mvp_inverse(camera: Node, volume_transform: Optional[Transform] = None):
    """``inv(P @ V @ M @ center)``: the inverse MVP the reference builds per
    frame (``MCMRenderer.js:164-175``)."""
    proj = camera.get_component(PerspectiveCamera).projection_matrix
    return m4.invert(m4.matmul(proj,
                               model_view_matrix(camera, volume_transform)))


@dataclasses.dataclass
class CameraState:
    """The three camera matrices a renderer needs, (4, 4) float32 each."""

    mvp_inverse: torch.Tensor
    model_view: torch.Tensor
    projection: torch.Tensor

    @staticmethod
    def from_nodes(camera: Node, volume_transform: Optional[Transform] = None):
        proj = camera.get_component(PerspectiveCamera).projection_matrix
        mv = model_view_matrix(camera, volume_transform)
        return CameraState(mvp_inverse=m4.invert(m4.matmul(proj, mv)),
                           model_view=mv, projection=proj)

"""Orbit camera (FluidSimDemo.cpp:144-163): the port's own copy of
fluidsimulation_tpu/render/camera.py, numpy only, bit for bit the same.

Builds the same camera-to-world frame the demo derives from its inverted
LookAt matrix: position on a radius-1.5 orbit around the origin, rows
(u=right, v=up, w=forward, Q=position), with the right/up rows pre-scaled by
the FOV factors (hScale = vScale*W/H, vScale = tan(fov/2)).  The renderer
consumes (co, right, up, fwd) directly instead of a 4x4 matrix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class OrbitCamera:
    """Defaults match the demo: phi = pi/2, theta = 0, fov = 60 deg
    (FluidSimDemo.cpp:66,92), radius 1.5 (FluidSimDemo.cpp:146)."""

    cam_phi: float = math.pi / 2.0
    cam_theta: float = 0.0
    fov: float = math.pi / 3.0
    radius: float = 1.5

    def frame(self, width: int, height: int):
        """Returns (co, right, up, fwd) float32 arrays; right/up are
        FOV-scaled so a ray is co + normalize(u*right + v*up + fwd)."""
        st, ct = math.sin(self.cam_theta), math.cos(self.cam_theta)
        sp, cp = math.sin(self.cam_phi), math.cos(self.cam_phi)
        pos = np.array(
            [self.radius * st * sp, self.radius * cp, -self.radius * ct * sp],
            np.float64,
        )
        target = np.zeros(3)
        up_world = np.array([0.0, 1.0, 0.0])
        fwd = target - pos
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(up_world, fwd)
        right = right / np.linalg.norm(right)
        up = np.cross(fwd, right)

        v_scale = math.tan(0.5 * self.fov)
        h_scale = v_scale * width / height
        return (
            pos.astype(np.float32),
            (right * h_scale).astype(np.float32),
            (up * v_scale).astype(np.float32),
            fwd.astype(np.float32),
        )

    # Interactive controls (FluidSimDemo.cpp:251-293) -----------------------

    def orbit(self, dx_pixels: float, dy_pixels: float):
        """Mouse-drag orbit: a quarter degree per pixel."""
        self.cam_theta -= math.radians(0.25 * dx_pixels)
        self.cam_phi -= math.radians(0.25 * dy_pixels)
        self.cam_phi = min(max(self.cam_phi, 0.1), math.pi - 0.1)

    def zoom(self, dy_pixels: float, client_height: int):
        """Exponential FOV zoom: a^client_height = 16."""
        v_height = 2.0 * math.tan(self.fov / 2.0)
        a = 16.0 ** (1.0 / client_height)
        v_height *= a ** (-dy_pixels)
        self.fov = 2.0 * math.atan(v_height / 2.0)

    def reset(self):
        """'0' key (FluidSimDemo.cpp:306-311)."""
        self.cam_phi = math.pi / 2.0
        self.cam_theta = 0.0
        self.fov = math.pi / 3.0

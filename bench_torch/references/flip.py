"""The plain reference of the 3D dam break's PIC/FLIP step
(harness/reference.py::flip_step), on the scene of a configuration file."""

import torch

from harness import reference

FIELDS = reference.FLIP_FIELDS


def step(scene: dict, state: dict, dt: float, dtype=torch.float32) -> dict:
    return reference.flip_step(reference.scene_of(scene), state, dt, dtype)

"""The plain reference of the 3D dam break's APIC step
(harness/reference.py::apic_step), on the scene of a configuration file."""

import torch

from harness import reference

FIELDS = reference.APIC_FIELDS


def step(scene: dict, state: dict, dt: float, dtype=torch.float32) -> dict:
    return reference.apic_step(reference.scene_of(scene), state, dt, dtype)

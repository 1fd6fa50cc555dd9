"""Where harness/faults.py plants its faults in the stand-in 2D sheet."""

SITES = ("standin2d.sheet", "step", "p2g", "update")


def half_batch(orig):
    """P2G over every other particle: each cell's mean over the rest."""
    return lambda cfg, pos, vel: orig(cfg, pos[::2], vel[::2])

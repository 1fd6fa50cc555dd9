"""Where harness/faults.py plants its faults in the 3D APIC step."""

SITES = ("fluidsimulation_tpu_torch.solver.apic", "step_apic", "p2g_apic", "g2p_apic")


def half_batch(orig):
    """P2G over every other particle."""
    return lambda cfg, pos, vel, C: orig(cfg, pos[::2], vel[::2], C[::2])

"""stage.transfer_ms, ms: device time a step of the operations launched
inside the P2G span and the particle-update span (FLIP: p2g_from_csr and
flip_update_carry; APIC: p2g_apic and g2p_apic)."""


def read(trace):
    return trace.stage_ms({"p2g", "particle_update"})

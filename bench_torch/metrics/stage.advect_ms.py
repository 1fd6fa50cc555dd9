"""stage.advect_ms, ms: device time a step of the operations launched
inside the advect span (the RK3 advection of the particles: FLIP's
advect_rk3_cached, APIC's advect_rk3_pic)."""


def read(trace):
    return trace.stage_ms({"advect"})

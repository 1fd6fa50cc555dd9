"""stage.advect_ms, ms: device time a step of the operations launched
inside the advect span (the RK3 advection of the particles: FLIP's
advect_rk3_cached, APIC's advect_rk3_pic), the RK3 stages' grid gathers
included. A device operation takes its innermost span, and the site table
flip_gather labels the gathers (ops/advect.py's interp_mac3_vec) gather
inside advect, so the reading is advect's own operations and the gather
spans' together. The other site tables label no operation gather, so
there it is the advect span's alone."""


def read(trace):
    return trace.stage_ms({"advect", "gather"})

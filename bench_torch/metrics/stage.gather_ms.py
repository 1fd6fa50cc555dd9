"""stage.gather_ms, ms: device time a step of the operations launched
inside the gather spans: the RK3 advection's grid gathers, each call of
ops/advect.py's interp_mac3_vec (two a FLIP step with its carried stage 1),
which the site table flip_gather labels gather inside advect."""


def read(trace):
    return trace.stage_ms({"gather"})

"""Where harness/faults.py plants its faults in the 3D FLIP step."""

SITES = ("fluidsimulation_tpu_torch.solver.step3d", "step", "p2g_from_csr", "flip_update_carry")


def half_batch(orig):
    """P2G over every other particle. FLIP's kernel walks the CSR index of
    all particles, so the half goes through the program's scatter form,
    which takes any particle order."""
    from fluidsimulation_tpu_torch.ops.cuda_p2g import p2g_accumulate_plain
    from fluidsimulation_tpu_torch.ops.p2g import _normalise

    return lambda cfg, csr, pcs, vels, x0=0: _normalise(
        cfg, p2g_accumulate_plain(cfg, pcs[::2], vels[::2], x0))

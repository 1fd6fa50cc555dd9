"""The multi-rank family over torch.distributed: port of
fluidsimulation_tpu/parallel/ (its hlo.py, which counts XLA collectives,
stays behind: comm.World.calls counts the port's).

  comm.py        World, the exchanges and collectives, Ranks / run_ranks
  halo.py        the x-slab SOR with halo exchange
  halo_step.py   the multi-rank FLIP step (make_halo_step, shard_state_x)
  halo_apic.py   the multi-rank APIC step (make_halo_apic_step)
  sharding.py    the GSPMD-layout entry points (make_sharded_step, ...)
  runs.py        rank-side runs of the five paths
  __main__.py    python -m fluidsimulation_tpu_torch.parallel: the five paths

The render of a frame over the ranks is render/sharded.py.
"""

"""The port's demo CLI, checkpoints and metrics against the JAX package's.

``main`` runs at 16^3 on the CPU. Its checkpoint loads in the JAX package
and a JAX checkpoint loads in the port, bit for bit; Meter and check_state
give the JAX answers on the same states."""

import logging
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.solver.step3d import step_jit
from fluidsimulation_tpu.utils import checkpoint as jax_cp
from fluidsimulation_tpu.utils import metrics as jax_metrics

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.app.demo import main
from fluidsimulation_tpu_torch.solver.step3d import clamp_dt
from fluidsimulation_tpu_torch.utils import checkpoint, metrics

ROOT = Path(__file__).resolve().parent.parent
N = 16
KW = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N))
CFG, JCFG = ft.SimConfig(**KW), JaxConfig(**KW)
FIELDS = ("pos", "vel", "u", "v", "w", "phi")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_demo_runs_and_saves_what_it_stepped(tmp_path, capsys):
    """Three demo steps at 16^3 (ppc 2, rate 0.5) save the state that three
    calls of ``step`` at the clamped dt give, and JAX's load_state reads it
    with its config check."""
    out = tmp_path / "out"
    assert main(["--grid", str(N), "--steps", "3", "--device", "cpu", "--save-state",
                 "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert f"grid {N}^3, {CFG.num_particles} particles on cpu" in text
    assert "step 0:" in text and "3 steps in" in text

    path = str(out / "final_state.npz")
    s = ft.init_state(CFG, "cpu")
    for _ in range(3):
        s = ft.step(s, clamp_dt(CFG, 1.0 / 60.0, 0.5), CFG)
    loaded = jax_cp.load_state(path, JCFG)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)),
                                      getattr(s, name).numpy(), err_msg=name)
    with pytest.raises(ValueError, match="cfg"):
        jax_cp.load_state(path, JaxConfig(nx=8, ny=8, nz=8, cells_per_meter=8.0))


def test_jax_checkpoint_loads_in_port_bit_exact(tmp_path):
    j = step_jit(jax_init(JCFG), 0.01, JCFG, fast=False)
    path = str(tmp_path / "jax.npz")
    jax_cp.save_state(path, j, JCFG)
    s = checkpoint.load_state(path, "cpu", CFG)
    assert s.k1 is None
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(s, name).numpy(), np.asarray(getattr(j, name)))
    # Round trip through the port's writer, with and without the config row.
    for cfg in (CFG, None):
        again = str(tmp_path / f"port_{cfg is None}.npz")
        checkpoint.save_state(again, s, cfg)
        back = checkpoint.load_state(again, "cpu", CFG)
        for name in FIELDS:
            torch.testing.assert_close(getattr(back, name), getattr(s, name), rtol=0, atol=0)
    with pytest.raises(ValueError, match="cfg"):
        checkpoint.load_state(path, "cpu", ft.SimConfig(nx=8, ny=8, nz=8, cells_per_meter=8.0))


@pytest.mark.parametrize("flag", [["--render-every", "2"], ["--two-d"], ["--transfer", "apic"],
                                  ["--profile"]])
def test_flags_of_unported_slices_are_refused(flag):
    with pytest.raises(SystemExit) as e:
        main([*flag, "--device", "cpu", "--steps", "0"])
    assert e.value.code != 0


def test_demo_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device would run")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--grid", "8", "--steps", "1"])


def test_stdin_commands_through_python_m(tmp_path):
    """`python -m fluidsimulation_tpu_torch` with FST_DEMO_STDIN: '+' then
    'q' quits after one step, before writing any checkpoint."""
    env = dict(os.environ, FST_DEMO_STDIN="1")
    proc = subprocess.run(
        [sys.executable, "-m", "fluidsimulation_tpu_torch", "--grid", "8", "--steps", "5",
         "--device", "cpu", "--out", str(tmp_path), "--save-state"],
        cwd=ROOT, input="+\nq\n", capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "1 steps in" in proc.stdout.splitlines()[-1]
    assert (tmp_path / "final_state.npz").exists()


def test_check_state_and_meter_match_jax(caplog):
    """The same verdict and the same log lines on four states: the initial
    one (phi = +inf), one step on (healthy), a NaN in phi, a fast particle."""
    j = step_jit(jax_init(JCFG), 0.01, JCFG, fast=False)
    bad_phi = ft.state_from_numpy(j, "cpu")
    bad_phi.phi[0, 0, 0] = float("nan")
    fast = ft.state_from_numpy(j, "cpu")
    fast.vel[3, 1] = 2e5
    cases = [(ft.init_state(CFG, "cpu"), False), (ft.state_from_numpy(j, "cpu"), True),
             (bad_phi, False), (fast, False)]
    for state, verdict in cases:
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            got = metrics.check_state(state)
            port_msgs = [r.getMessage() for r in caplog.records]
            caplog.clear()
            want = jax_metrics.check_state(SimpleNamespace(**ft.state_to_numpy(state)))
            jax_msgs = [r.getMessage() for r in caplog.records]
        assert got is want is verdict
        assert port_msgs == jax_msgs



def test_meter_matches_jax(monkeypatch):
    """On one fake clock both meters give the same numbers and summary."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    meters = [metrics.Meter(CFG.num_particles), jax_metrics.Meter(CFG.num_particles)]
    for m in meters:
        m.tick()
        m.tick(4)
    clock[0] = 102.5
    for m in meters:
        assert (m.steps, m.elapsed, m.steps_per_sec) == (5, 2.5, 2.0)
        assert m.particles_per_sec == 2.0 * CFG.num_particles
    assert meters[0].summary() == meters[1].summary() == (
        f"5 steps in 2.50s = 2.00 steps/s, {2.0 * CFG.num_particles:.3e} particles/s")

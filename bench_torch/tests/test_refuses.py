"""Without a card the benchmark prints no result and exits non-zero; so
does a checkout that holds only BENCHMARK.json and the benchmark's folder,
a configuration whose reference has no file, and a process that holds JAX
or the JAX package once the window has closed."""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

import run
from harness import catalog

ARGS = ["--workload", "demo64.flip", "--seed", str(2**31 + 9), "--seconds", "0.3", "--trace", "0"]


def _small_demo() -> dict:
    conf = catalog.config("demo64")
    conf["scene"].update(nx=12, ny=12, nz=12, cells_per_meter=12.0)
    return conf


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _run(catalog.ROOT, "bench_torch/run.py", "--workload", "demo64.flip", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert proc.returncode == 3, proc.stderr
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.BENCH, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, 'bench_torch'); import run; "
            "sys.exit(run.main(['--workload', 'demo64.flip', '--seed', '1', '--seconds', '1', "
            "'--trace', '0'], dev=torch.device('cpu')))")
    proc = _run(tmp_path, "-c", code)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "fluidsimulation_tpu_torch" in proc.stderr


def test_a_reference_without_its_file_stops_the_run_before_any_step(monkeypatch):
    conf = _small_demo()
    conf["program"]["transfers"]["flip"]["reference"] = "absent"

    def no_loop(*args, **kwargs):
        raise AssertionError("the run reached its first step")

    monkeypatch.setattr(run, "Loop", no_loop)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(catalog.CatalogError) as err:
        run.main(ARGS, dev=torch.device("cpu"), conf=conf)
    assert str(catalog.BENCH / "references" / "absent.py") in str(err.value)
    assert out.getvalue() == ""


def test_barred_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "fluidsimulation_tpu_torch_extra", types.ModuleType("x"))
    assert run.barred_modules() == []
    monkeypatch.setitem(sys.modules, "fluidsimulation_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert run.barred_modules() == ["fluidsimulation_tpu", "jaxlib"]


def test_a_process_that_holds_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(ARGS, dev=torch.device("cpu"), conf=_small_demo()) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "holds jax" in captured.err

"""A configuration with its own scene keys, state fields, reference and
faults comes in as new files and new entries alone: in a temporary copy of
the benchmark, the stand-in 2D program of newcell/ (a scene with no nz, the
fields pos, vel and grid) and its configuration, traffic mix, site table,
references/pic2d.py and faults/pic2d.py are added, and a run of the new
cell on the CPU reaches the check and reads ``correct`` true; with each
fault of harness/faults.py planted where faults/pic2d.py says (the
update's velocities 1% off among them), ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import catalog, faults

NEWCELL = catalog.BENCH / "tests" / "newcell"
CELL = "sheet2d.pic2d"

DRIVE = """
import contextlib, io, json, sys
import torch
sys.path.insert(0, "bench_torch")
import run
from harness import faults
out = {}
for fault in [None, *faults.FAULTS]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), (faults.planted(fault, "pic2d") if fault
                                           else contextlib.nullcontext()):
        rc = run.main(["--workload", "%s", "--seed", str(2**31 + 77), "--seconds", "0.3",
                       "--trace", "0"], dev=torch.device("cpu"))
    out[str(fault)] = {"rc": rc, "result": json.loads(buf.getvalue().strip().splitlines()[-1])}
print(json.dumps(out))
""" % CELL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(catalog.BENCH, root / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(NEWCELL / "bench_torch", root / "bench_torch", dirs_exist_ok=True)
    shutil.copytree(NEWCELL / "standin2d", root / "standin2d")
    bench = catalog.benchmark()
    bench["configs"].append({"name": "sheet2d", "source": "a stand-in",
                             "file": "bench_torch/configs/sheet2d.json", "reduced": [],
                             "why": "a 2D scene"})
    bench["workloads"].append({"name": CELL, "config": "sheet2d", "traffic": "pic2d",
                               "chips": 1, "why": "a 2D stand-in"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_new_files_are_all_it_takes():
    """Nothing of the stand-in is in the benchmark itself: its scene has no
    nz and its fields are not the 3D set."""
    scene = json.loads((NEWCELL / "bench_torch/configs/sheet2d.json").read_text())["scene"]
    assert "nz" not in scene
    with pytest.raises(catalog.CatalogError):
        catalog.reference("pic2d")
    ref = catalog.reference("pic2d", NEWCELL / "bench_torch")
    assert ref.FIELDS == ("pos", "vel", "grid")
    assert catalog.faults("pic2d", NEWCELL / "bench_torch").SITES[0] == "standin2d.sheet"


def test_the_new_cell_reaches_the_check_and_is_correct(runs):
    r = runs["None"]
    assert r["rc"] == 0
    result = r["result"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"off_share.pos", "off_share.vel", "off_share.grid",
                                     "worst_rel_l2"}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_of_the_new_cell_turns_correct_false(runs, fault):
    r = runs[fault]
    assert r["rc"] == 0
    assert r["result"]["correct"] is False, r["result"]["checks"]

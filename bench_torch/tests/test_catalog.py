import json
import os
import subprocess
import sys

import pytest

from harness import catalog


def test_every_cell_of_the_benchmark_finds_its_files():
    bench = catalog.benchmark()
    for cell in bench["workloads"]:
        conf = catalog.config(cell["config"])
        mix = catalog.traffic(cell["traffic"])
        assert conf["name"] == cell["config"] and mix["name"] == cell["traffic"]
        entries = conf["program"]["transfers"][mix["transfer"]]
        assert catalog.sites(entries["sites"])
        ref = catalog.reference(entries["reference"])
        assert callable(ref.step) and ref.FIELDS
        table = catalog.faults(entries["reference"])
        assert len(table.SITES) == 4 and callable(table.half_batch)
        for m in catalog.per_layer(bench, cell["name"]):
            assert callable(catalog.metric_reader(m["name"]).read)


def test_configs_name_their_files_and_state_them_whole():
    bench = catalog.benchmark()
    for c in bench["configs"]:
        assert c["file"] == f"bench_torch/configs/{c['name']}.json"
        conf = catalog.config(c["name"])
        assert conf["source"] and conf["reduced"] == c["reduced"]


def test_metrics_are_selected_by_cell():
    bench = catalog.benchmark()
    for cell in bench["workloads"]:
        assert catalog.per_layer(bench, cell["name"])
    # A cell that step_ms_p95 does not list, as a long-step cell would be.
    bench["workloads"].append({"name": "demo64.long", "config": "demo64", "traffic": "flip"})
    names = [m["name"] for m in catalog.end_to_end(bench, "demo64.long")]
    assert "step_ms_p95" not in names and "step_ms" in names and "setup_s" in names
    names = [m["name"] for m in catalog.end_to_end(bench, "demo64.flip")]
    assert "step_ms_p95" in names


def test_a_cell_added_as_files_is_found(tmp_path):
    """A later cell needs only new files and new entries."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "sites").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps({"name": "tiny", "scene": {"nx": 8}}))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps({"name": "burst", "rate": 1.0}))
    (tmp_path / "sites" / "two.json").write_text(json.dumps([["solver.x", "f", "f"]]))
    (tmp_path / "metrics" / "x.count.py").write_text(
        "def capture(captured):\n    return {'n': 1}\n\ndef read(trace):\n    return 7.0\n")
    (tmp_path / "references").mkdir()
    (tmp_path / "faults").mkdir()
    (tmp_path / "references" / "line1d.py").write_text(
        "import dataclasses\n\n@dataclasses.dataclass\nclass Line:\n    n: int\n\n"
        "FIELDS = ('x',)\n\ndef step(scene, state, dt, dtype=None):\n    return state\n")
    (tmp_path / "faults" / "line1d.py").write_text(
        "SITES = ('m', 's', 'p', 'u')\n\ndef half_batch(orig):\n    return orig\n")
    assert catalog.config("tiny", tmp_path)["scene"]["nx"] == 8
    assert catalog.traffic("burst", tmp_path)["rate"] == 1.0
    assert catalog.sites("two", tmp_path) == [("solver.x", "f", "f")]
    reader = catalog.metric_reader("x.count", tmp_path)
    line1d = catalog.reference("line1d", tmp_path)
    assert line1d.FIELDS == ("x",) and line1d.Line(3).n == 3
    assert catalog.faults("line1d", tmp_path).SITES == ("m", "s", "p", "u")
    assert reader.read(None) == 7.0 and reader.capture({}) == {"n": 1}
    bench = {"workloads": [{"name": "tiny.burst", "config": "tiny", "traffic": "burst"}],
             "end_to_end": [{"name": "step_ms"}, {"name": "p", "workloads": ["other"]}],
             "per_layer": [{"name": "x.count", "moves": "step_ms"},
                           {"name": "y", "moves": "p"},
                           {"name": "z", "moves": "step_ms", "workloads": ["other"]}]}
    assert catalog.workload(bench, "tiny.burst")["config"] == "tiny"
    assert [m["name"] for m in catalog.end_to_end(bench, "tiny.burst")] == ["step_ms"]
    assert [m["name"] for m in catalog.per_layer(bench, "tiny.burst")] == ["x.count"]
    with pytest.raises(catalog.CatalogError):
        catalog.config("absent", tmp_path)
    with pytest.raises(catalog.CatalogError):
        catalog.metric_reader("absent", tmp_path)
    for find in (catalog.reference, catalog.faults):
        with pytest.raises(catalog.CatalogError, match="absent.py"):
            find("absent", tmp_path)
    with pytest.raises(catalog.CatalogError):
        catalog.workload(bench, "absent")


def test_the_references_import_nothing_of_the_program():
    """Every references/<name>.py, loaded as a run loads it, leaves the
    program's package and JAX out of a fresh process."""
    names = sorted(p.stem for p in (catalog.BENCH / "references").glob("*.py"))
    code = ("import sys; sys.path.insert(0, 'bench_torch'); from harness import catalog\n"
            f"for n in {names!r}: catalog.reference(n)\n"
            "print(sorted({m.partition('.')[0] for m in sys.modules} & "
            "{'fluidsimulation_tpu_torch', 'fluidsimulation_tpu', 'jax'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert names and proc.stdout.strip() == "[]"

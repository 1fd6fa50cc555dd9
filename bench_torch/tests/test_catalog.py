import json

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
    assert catalog.config("tiny", tmp_path)["scene"]["nx"] == 8
    assert catalog.traffic("burst", tmp_path)["rate"] == 1.0
    assert catalog.sites("two", tmp_path) == [("solver.x", "f", "f")]
    reader = catalog.metric_reader("x.count", tmp_path)
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
    with pytest.raises(catalog.CatalogError):
        catalog.workload(bench, "absent")

"""BENCHMARK.json against the contract's shape, and every name it holds
resolving to its file."""

import json
import re
import shutil

import pytest

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_and_cells_agree():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved_cells = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved_cells, m["name"]
        layers.setdefault(m["layer"], m["layer"])
    for w in BENCH["workloads"]:
        cell = manifest.Cell(w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert cell.workload["rate_metric"] in {m["name"] for m in cell.end_to_end}
        assert w["chips"] == 1


def test_every_file_resolves():
    used = set()
    for w in BENCH["workloads"]:
        cell = manifest.Cell(w["name"])
        used.add(w["config"])
        assert hasattr(manifest.program(cell.workload["program"]), "Program")
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_configs_hold_their_ymls():
    yaml = pytest.importorskip("yaml")
    for c in BENCH["configs"]:
        config = manifest.load_json(manifest.ROOT / c["file"])
        with open(manifest.ROOT / config["yml"]) as f:
            yml = yaml.safe_load(f)
        extra = dict(config["cfg"]["SOLVER"])
        assert extra.pop("MARGIN") == 0.3  # the default, written out for the reference
        assert {k: v for k, v in config["cfg"].items() if k != "SOLVER"} == \
            {k: v for k, v in yml.items() if k != "SOLVER"}
        assert extra == yml["SOLVER"]
        assert c["reduced"] == config["reduced"]


def test_a_new_cell_is_new_files(tmp_path):
    """A throwaway workload beside the others: one file and one entry."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    entry = dict(bench["workloads"][0], name="vitb16-uniprompt.stage2a-long", traffic="long")
    bench["workloads"].append(entry)
    workload = manifest.load_json(
        manifest.ROOT / "portbench/workloads/vitb16-uniprompt.stage2a.json")
    workload["traffic"]["rows_per_unit"] = 64
    with open(root / "portbench/workloads/vitb16-uniprompt.stage2a-long.json", "w") as f:
        json.dump(workload, f)
    cell = manifest.Cell("vitb16-uniprompt.stage2a-long", bench, root)
    assert cell.workload["traffic"]["rows_per_unit"] == 64
    assert cell.config["name"] == "vitb16-uniprompt"
    assert hasattr(manifest.program(cell.workload["program"], root), "Program")

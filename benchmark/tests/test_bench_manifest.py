"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files (CPU)."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import manifest as MF

ROOT = MF.ROOT
MAN = MF.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    assert all(one_line(w) for w in MAN["command"])
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(MAN["run_seconds"], int) \
        and 1 <= MAN["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    rs = MAN["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_keys_names_units():
    keys = dict(configs={"name", "source", "file", "reduced", "why"},
                workloads={"name", "config", "traffic", "chips", "why"},
                end_to_end={"name", "unit", "better", "bound", "source"},
                per_layer={"name", "unit", "better", "source", "layer",
                           "moves"})
    names = set()
    for section, want in keys.items():
        for e in MAN[section]:
            extra = set(e) - want
            assert set(e) >= want and extra <= {"workloads"} \
                and (not extra or section in ("end_to_end", "per_layer"))
            assert NAME.match(e["name"]), e["name"]
            if section in ("end_to_end", "per_layer"):
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
                assert e["name"] not in names
                names.add(e["name"])
    for section in ("configs", "workloads"):
        assert len({e["name"] for e in MAN[section]}) == len(MAN[section])


def test_metrics_follow_the_rules():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
    rooflines = [m for m in MAN["per_layer"] if "roofline" in m["name"]]
    assert all(m["unit"] == "%" for m in rooflines)


def test_configs_and_cells():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == set(configs)
    assert len({c["file"] for c in MAN["configs"]}) == len(configs)
    for c in MAN["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16
        data = json.loads((ROOT / c["file"]).read_text())
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    assert all(one_line(w["why"]) for w in MAN["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_resolves(cell):
    c = MF.resolve(cell)
    for f in c.config["calib"]:
        assert (c.config_dir / f).is_file()
    assert c.config["limits"], "a cell compares at least one number"
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(MF.reader(m.name))
        assert m.moves in names


def test_a_new_cell_is_data_alone(tmp_path):
    """A copy of the benchmark with one more traffic file and one more
    workload entry resolves the new cell: no file of the harness edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (ROOT / "benchmark/traffic/cruise.json").read_text())
    traffic.update(translation_amp_m=[0.76, 0.56, 0.40])
    (tmp_path / "benchmark/traffic/agile.json").write_text(
        json.dumps(traffic))
    man["workloads"].append(dict(
        name="euroc_mono.agile", config="euroc_mono", traffic="agile",
        chips=1, why="twice the cruise's motion a frame"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.harness import manifest as MF;"
            "c = MF.resolve('euroc_mono.agile');"
            "assert str(MF.ROOT) == sys.argv[1], MF.ROOT;"
            "print(c.traffic['translation_amp_m'], len(c.per_layer))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[0.76, 0.56, 0.4]")


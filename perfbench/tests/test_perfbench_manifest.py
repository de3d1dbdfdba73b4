"""`BENCHMARK.json` against the files it names and the rules its names,
units and cells keep."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file()
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "perfbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    assert w["chips"] == 1


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
        assert m["better"] == "higher"


def test_every_config_and_cell_covered():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        reported = [e for e in BENCH["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert any(e["name"] == "setup_s" for e in reported)
        assert any(e["name"] != "setup_s" for e in reported)
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])


def test_bounds():
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_configs_hold_their_presets():
    import dataclasses
    import sys

    sys.path.insert(0, str(ROOT))
    from perfbench.harness import build_config
    from veon_tpu_torch.configs import presets

    for conf in BENCH["configs"]:
        body = json.loads((ROOT / conf["file"]).read_text())
        assert body["name"] == conf["name"] and body["reduced"] == conf["reduced"] == []
        cfg = build_config(presets, body)
        assert dataclasses.asdict(cfg)["compute_dtype"] == "bfloat16"

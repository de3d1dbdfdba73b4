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


def _body(conf):
    return json.loads((ROOT / conf["file"]).read_text())


@pytest.mark.parametrize("num_temporal", [1, 2])
@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_built_from_their_files(conf, num_temporal):
    """Each side's configuration built from the file alone equals the one
    the port's preset builds, field for field and hash included; the
    reference's holds those values in its own classes."""
    import dataclasses
    import sys

    sys.path.insert(0, str(ROOT))
    from perfbench.harness import build_config, config_from_file
    from perfbench.reference.configs import base as ref_base
    from veon_tpu_torch.configs import base as port_base
    from veon_tpu_torch.configs import presets

    body = _body(conf)
    for dtype in (None, "float32"):
        preset = build_config(presets, body, num_temporal, dtype)
        port = config_from_file(port_base, body, num_temporal, dtype)
        assert port == preset and hash(port) == hash(preset)
        ref = config_from_file(ref_base, body, num_temporal, dtype)
        assert type(ref) is ref_base.VeonConfig and type(ref.san) is ref_base.SANConfig
        assert dataclasses.astuple(ref) == dataclasses.astuple(preset)
        assert hash(ref) == hash(preset)


def test_miniature_built_from_its_sizes():
    """The reference's miniature built from its sizes equals the one its
    preset builds, in the same classes, hash included."""
    import dataclasses
    import sys

    sys.path.insert(0, str(ROOT))
    from perfbench.harness import _as_lists, build_config, config_from_file
    from perfbench.reference.configs import base as ref_base
    from perfbench.reference.configs import presets as ref_presets

    sizes = _as_lists(dataclasses.asdict(ref_presets.veon_tiny_test()))
    sizes.pop("num_temporal")
    sizes.pop("compute_dtype")
    conf = {"name": "tiny", "preset": "veon_tiny_test", "compute_dtype": "float32",
            "sizes": json.loads(json.dumps(sizes))}
    for num_temporal in (1, 2):
        got = config_from_file(ref_base, conf, num_temporal)
        want = build_config(ref_presets, conf, num_temporal)
        assert got == want and hash(got) == hash(want)


REFUSED = [
    ("unknown", lambda s: s.update(bogus=1), "has unknown keys ['bogus']"),
    ("unknown_nested", lambda s: s["san"].update(bogus_width=8),
     "has unknown keys ['san.bogus_width']"),
    ("missing", lambda s: s.pop("zoe"), "misses keys ['zoe']"),
    ("missing_nested", lambda s: s["hsa"].pop("fusion_map"), "misses keys ['hsa.fusion_map']"),
    ("not_a_whole_number", lambda s: s["san"].update(clip_width=768.5),
     "san.clip_width is not of type int"),
    ("too_short", lambda s: s["grid"].update(x=[-40.0, 40.0]), "grid.x has 2 entries, not 3"),
    ("not_a_list", lambda s: s["hsa"].update(fusion_map=[[0, 3, 3], 7]),
     "hsa.fusion_map[1] is not a list"),
    ("run_setting", lambda s: s.update(num_temporal=2), "sizes may not hold ['num_temporal']"),
]


@pytest.mark.parametrize("edit,message", [r[1:] for r in REFUSED], ids=[r[0] for r in REFUSED])
def test_file_refused_by_key(edit, message):
    import copy
    import sys

    sys.path.insert(0, str(ROOT))
    from perfbench.harness import config_from_file
    from perfbench.reference.configs import base as ref_base

    body = copy.deepcopy(_body(BENCH["configs"][0]))
    edit(body["sizes"])
    with pytest.raises(ValueError, match=re.escape(message)):
        config_from_file(ref_base, body, 2)

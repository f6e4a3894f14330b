"""BENCHMARK.json against the contract it is written to, and every file it
names found by name."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.manifest()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                    for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its time: 2 + 14 n runs, 2 x 90 s of
    # compiling a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and key != "source":
                assert _line(e[key]), (e["name"], key)


def test_configs_found_by_name():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = harness.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for kind in ("reference", "work"):
            assert (harness.HERE / kind / f"{cfg['family']}.py").is_file()
        assert (harness.HERE / "inputs" / f"{c['name']}.py").is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_config_files_hold_the_programs_configuration():
    """Nothing is cut: each configuration file's values are the port's
    registered configuration's."""
    import dataclasses

    from position_induced_transformer_torch import configs

    for c in BENCH["configs"]:
        cfg = harness.config(c["name"])
        base = configs.get(c["name"])
        assert dataclasses.asdict(base.model) == cfg["model"]
        for k, v in dataclasses.asdict(base).items():
            if k in cfg and k != "model":
                assert cfg[k] == v, (c["name"], k)


def test_workloads_found_by_name():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = harness.mix(w["traffic"])
        assert (harness.HERE / "traffic" / f"{mix['kind']}.py").is_file()
        assert harness.limits(w["name"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert callable(harness.reader(m["name"]).read)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # every cell that reports a layer metric reports the metric it moves
        moved = e2e[m["moves"]]
        for w in m.get("workloads", []):
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)


def test_every_cell_reports_enough():
    from portbench.run import reported

    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(reported(m, w["name"], BENCH) for m in BENCH["per_layer"]), w["name"]


def test_a_layer_metric_without_cells_is_read_where_its_metric_is():
    """A per-layer metric without ``workloads`` is read in every cell that
    reports the end-to-end metric it moves, those added later too."""
    from portbench.run import reported

    bench = {"end_to_end": [{"name": "a", "workloads": ["x.train"]}, {"name": "setup_s"}],
             "per_layer": []}
    assert reported({"moves": "a"}, "x.train", bench)
    assert not reported({"moves": "a"}, "x.infer", bench)
    assert reported({"moves": "setup_s"}, "any.cell", bench)
    assert not reported({"moves": "a", "workloads": ["y.train"]}, "x.train", bench)


def test_metrics_of_one_layer_agree_on_its_name():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers

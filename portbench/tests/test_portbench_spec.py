"""BENCHMARK.json keeps to the benchmark format's names and units, and every cell
finds its configuration, traffic, span, metric and limit files by name."""

import glob
import os
import re

import pytest

from _helpers import PB, ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == KEYS
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    assert len(set(names)) == len(names)
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entries_have_only_the_allowed_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_its_files(cell):
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    cfg = next(c for c in b["configs"] if c["name"] == w["config"])
    assert os.path.exists(os.path.join(ROOT, cfg["file"]))
    assert os.path.exists(os.path.join(PB, "traffic", w["traffic"] + ".json"))
    assert os.path.exists(os.path.join(PB, "limits", cell + ".json"))
    for m in b["per_layer"]:
        if "workloads" in m:
            assert set(m["workloads"]) <= {x["name"] for x in b["workloads"]}
        assert os.path.exists(os.path.join(PB, "metrics", m["name"] + ".py"))
    assert glob.glob(os.path.join(PB, "spans", "*.py"))

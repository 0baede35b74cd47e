"""BENCHMARK.json against the benchmark's contract: names, units, keys and
the files it names."""

import json
import re

import pytest

from conftest import BENCH

from dfbench import loop

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def all_names():
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[sec]:
            yield e["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source"}
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        keys |= {"bound"}
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (BENCH / "metrics" / f"{metric['name']}.py").exists()
        keys |= {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_cells_and_files():
    cells = {w["name"] for w in SPEC["workloads"]}
    assert len(cells) == len(SPEC["workloads"])
    assert {"setup_s"} <= {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        _, config, mix = loop.cell_files(SPEC, w["name"])
        assert config["reduced"] == next(
            c["reduced"] for c in SPEC["configs"] if c["name"] == w["config"])
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = [m for m in SPEC["end_to_end"] if loop.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(loop.applies(m, w["name"]) for m in SPEC["per_layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51

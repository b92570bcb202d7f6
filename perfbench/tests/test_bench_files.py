"""The benchmark is driven by data: cells, configurations, mixes and
per-layer metrics are files found by name, and BENCHMARK.json keeps to
its contract's shape."""
import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_entries_and_their_files():
    b = harness.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in b["configs"]:
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        assert harness.driver(conf["driver"]).run
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in b["per_layer"]:
        mod = harness.reader(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                   m["moves"])
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        c = harness.cell(w["name"])
        assert c["traffic"] and c["config"]
        assert {"setup_s"} < {m["name"] for m in c["end_to_end"]}
        assert c["per_layer"]
        moved = {m["name"] for m in c["end_to_end"]}
        assert all(m["moves"] in moved for m in c["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_traffic_file_is_found_by_name(tmp_path, monkeypatch):
    """A cell added by data alone: a new mix file and a new entry, no
    code edited."""
    bench = tmp_path / "perfbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = dict(harness.traffic("chat-closed64"), clients=16)
    (bench / "traffic" / "chat-closed16.json").write_text(json.dumps(mix))
    b = harness.benchmark()
    b["workloads"].append({"name": "moe-chat-closed16",
                           "config": "qwen3-moe-30b-a3b",
                           "traffic": "chat-closed16", "chips": 1,
                           "why": "fewer clients"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "moe-chat-closed64" in m.get("workloads", []):
            m["workloads"].append("moe-chat-closed16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    c = harness.cell("moe-chat-closed16")
    assert c["traffic"]["clients"] == 16
    assert c["config"]["name"] == "qwen3-moe-30b-a3b"
    assert {m["name"] for m in c["per_layer"]} == {
        m["name"] for m in harness.cell("moe-chat-closed64")["per_layer"]}
    with pytest.raises(KeyError):
        harness.cell("no-such-cell")

"""The harness on the CPU: traffic from the seed, the files of
BENCHMARK.json, the import rules, discovery of new cells' files by name,
and the refusals of ``bench/run.py``."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_harness as H
import bench_tiny
import bench_traffic as T

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
TRAFFIC = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", TRAFFIC)
def test_traffic_same_for_a_seed_and_different_for_two(name):
    spec = T.load(BENCH, name)
    a, b, c = (T.Traffic(spec, 1000, s) for s in (7, 7, 2**31 + 9))
    for i in (0, 5, 200):
        sa, sb, sc = a.session(i), b.session(i), c.session(i)
        assert np.array_equal(sa.prompt, sb.prompt) and sa.output == \
            sb.output
        for _ in range(3):
            ra, rb = a.round(sa), b.round(sb)
            assert all(np.array_equal(x, y) for x, y in zip(ra, rb))
    assert any(not np.array_equal(a.session(i).prompt, c.session(i).prompt)
               for i in range(4))
    # every seed serves the same sizes in the same order; only ids differ
    for i in range(2 * a.block):
        sa, sc = a.session(i), c.session(i)
        assert len(sa.prompt) == len(sc.prompt) and sa.output == sc.output
        ra, rc = a.round(sa), c.round(sc)
        assert len(ra[0]) == len(rc[0])
    # each block holds the same prompt and output lengths
    blk = a.block
    for b in (1, 2):
        assert sorted(len(a.session(b * blk + i).prompt)
                      for i in range(blk)) == sorted(
            len(a.session(i).prompt) for i in range(blk))


@pytest.mark.parametrize("name", TRAFFIC)
def test_traffic_lengths_in_range(name):
    spec = T.load(BENCH, name)
    tr = T.Traffic(spec, 151936, 3)
    p, o = spec["prompt_tokens"], spec["output_tokens"]
    for i in range(3 * tr.block):
        s = tr.session(i)
        assert p["min"] <= len(s.prompt) <= p["max"]
        assert o["min"] <= s.output <= o["max"]
        assert s.prompt.min() >= 0 and s.prompt.max() < 151936
        dev, draft = tr.round(s)
        assert 0 <= len(dev) <= tr.device_max() and len(draft) == \
            spec["gamma"] == 4
        assert len(dev) % spec["device_tokens"]["chunk"] == 0
        assert 1 <= tr.first_output(s, 0) <= s.output
    for cell in BM["workloads"]:
        if cell["traffic"] == name:
            cfg = H.load_config(ROOT, H.find_cell(BM, cell["name"])[1])
            assert tr.longest_stream() <= cfg["serve"]["s_max"]
            # a round's uncached tokens and drafts fit one verify chunk
            assert 1 + tr.device_max() + spec["gamma"] <= \
                cfg["serve"]["chunk"]


def test_chat_lengths_follow_the_stated_distribution():
    """The source's means (LMSYS-Chat-1M: 69.5 and 214.5 tokens) within
    1% over one block of quantiles, none clipped; the device tokens'
    mean is 4 E[min(K, 6)] for K geometric with keep 0.8 (11.80)."""
    spec = T.load(BENCH, "chat")
    for key, mean, hi in (("prompt_tokens", 69.5, 337),
                          ("output_tokens", 214.5, 1041)):
        q = T.quantiles(spec[key], spec["block"])
        assert abs(q.mean() - mean) / mean < 0.01
        assert q.max() == hi < spec[key]["max"]
        assert q.min() > spec[key]["min"] or q.min() == 1
    tr = T.Traffic(spec, 1000, 5)
    ses = tr.session(0)
    n = [len(tr.round(ses)[0]) for _ in range(20000)]
    want = 4 * sum(0.8 ** j for j in range(1, 7))
    assert abs(np.mean(n) - want) < 0.3


def _metrics():
    return BM["end_to_end"] + BM["per_layer"]


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in BM["configs"]]
             + [w["name"] for w in BM["workloads"]]
             + [m["name"] for m in _metrics()]
             + [w["config"] for w in BM["workloads"]]
             + [w["traffic"] for w in BM["workloads"]]
             + [k for c in BM["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in _metrics())
    for group in (BM["configs"], BM["workloads"], _metrics()):
        assert len({g["name"] for g in group}) == len(group)
    texts = ([c["why"] for c in BM["configs"] + BM["workloads"]]
             + [m["layer"] for m in BM["per_layer"]]
             + [c["source"] for c in BM["configs"]] + BM["command"])
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def test_benchmark_file_follows_its_contract():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"] and BM["command"][1] == "bench/run.py"
    assert 1 <= BM["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["better"] in
               ("lower", "higher") and m["source"] in
               ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"]: w for w in BM["workloads"]}
    assert all(w["chips"] == 1 for w in cells.values())
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in BM["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            reported = [x for x in BM["end_to_end"]
                        if w in x.get("workloads", cells)]
            assert m["moves"] in {x["name"] for x in reported}
    assert len(json.dumps(BM)) < 64 * 1024


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_in_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    # the names are compared whole: the port's own name passes
    assert "repro_torch" not in FORBIDDEN and "repro_torch".split(".")[0] \
        != "repro"


def test_reference_and_yardstick_import_nothing_of_the_program():
    for name in ("bench_reference.py", "bench_counts.py",
                 "bench_traffic.py", "bench_trace.py"):
        assert not (_imports(BENCH / name) & (FORBIDDEN | {"repro_torch"}))


def test_forbidden_modules_compares_whole_top_level_names():
    clean = ["repro_torch", "repro_torch.models.model", "jax_like", "numpy"]
    assert H.forbidden_modules(clean) == []
    assert H.forbidden_modules(clean + ["repro.models", "jaxlib"]) == [
        "jaxlib", "repro"]
    assert H.forbidden_modules(["flax.linen", "jax.numpy"]) == ["flax",
                                                                "jax"]


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric dropped into
    a copy of bench/'s data folders run as a cell with no code edit."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    cfg = bench_tiny.config("qwen1.5-7b")
    cfg["name"] = "tiny-dense"
    (bench / "configs" / "tiny-dense.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(
        json.dumps(bench_tiny.traffic()))
    (bench / "metrics" / "served_sessions.py").write_text(
        "def read(r):\n"
        "    return float(sum(it['events'] for it in r.iterations\n"
        "                     if it['kind'] == 'verify'))\n")
    bm = dict(BM)
    bm["configs"] = BM["configs"] + [dict(
        name="tiny-dense", source="test", file="bench/configs/tiny-dense.json",
        reduced=[], why="test")]
    bm["workloads"] = BM["workloads"] + [dict(
        name="tiny-dense.tiny", config="tiny-dense", traffic="tiny",
        chips=1, why="test")]
    bm["per_layer"] = BM["per_layer"] + [dict(
        name="served_sessions", unit="n", better="higher",
        source="program_counter", layer="scheduler",
        moves="served_tokens_per_s", workloads=["tiny-dense.tiny"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    loaded = H.load_benchmark(tmp_path)
    cell, entry = H.find_cell(loaded, "tiny-dense.tiny")
    got_cfg = H.load_config(tmp_path, entry)
    spec = T.load(bench, cell["traffic"])
    names = [m["name"] for m in H.metric_names(loaded, "tiny-dense.tiny",
                                                 "per_layer")]
    assert "served_sessions" in names
    assert H.load_metric("served_sessions", bench).read(
        H.Readings(cfg=got_cfg, window_s=1.0, iterations=[
            dict(kind="verify", events=3)], useful_flops=0)) == 3.0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = H.run_cell(got_cfg, spec, seed=11, seconds=bench_tiny.SECONDS,
                         trace=True, metrics=[], per_layer=[
                             ("served_sessions", "n")], device="cpu",
                         dtype="float32", trace_path=tmp_path / "t.json",
                         bench_dir=bench)
    finally:
        torch.set_num_threads(threads)
    assert res["correct"], res["checks"]
    assert res["metrics"]["served_sessions"]["value"] > 0
    # the copy's metric file, not the checkout's, is what run_cell read
    assert "served_sessions" not in {p.stem for p in
                                     (BENCH / "metrics").glob("*.py")}


def test_tiny_run_is_correct_and_reports_its_metrics():
    res = bench_tiny.run("qwen1.5-7b", seed=2**31 + 17)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 10
    assert res["metrics"]["served_tokens_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["tokens_checked"]["value"] >= 10
    assert res["host"]["process_cpu_share"] > 0


def test_useful_row_share_counts_the_padding_rows(tmp_path):
    """The rows run are every forward's slots x feed width, padding
    included: at 4 slots a verify forward runs 4 x 32 rows whatever it
    feeds, so the share is above 0 and well under 100%."""
    res = bench_tiny.run("qwen1.5-7b", seed=23, trace=True,
                         trace_path=tmp_path / "t.json",
                         per_layer=[("useful_row_share", "%"),
                                    ("verify_slots_per_iter", "slots")])
    share = res["metrics"]["useful_row_share"]["value"]
    assert 0 < share < 90


def _run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen1.5-7b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is not taken")
    res = _run_py(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_run_refuses_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_py(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""

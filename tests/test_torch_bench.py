"""The port's live and shard benches and its benchmark runner, against the
JAX package's on the CPU.

Both packages build the paper's SOM testbed (2K rows, seed 0) into a store
(the same triples and term ids, ``tests/test_torch_serve.py``) and run
their ``bench_live`` / ``bench_shard`` over it.  Timings differ; what the
benches count must not: the report's key tree, the warm matches, the delta
fractions, the compacted triples, the fan-out per query and the shard
counters.  The runner writes its reports only into ``--json-dir``.
"""

import json
import os
import pathlib

import pytest
import torch

from repro.core.executor import create_kg as jax_create_kg
from repro.live.bench import bench_live as jax_bench_live
from repro.rml import generator as jax_generator
from repro.shard.bench import bench_shard as jax_bench_shard
from repro_torch.bench import dedup_gather
from repro_torch.bench import run as runner
from repro_torch.configs import wide_deep
from repro_torch.core import distributed
from repro_torch.core.executor import create_kg
from repro_torch.live.bench import bench_live
from repro_torch.models.recsys import WideDeep
from repro_torch.rml import generator
from repro_torch.shard.bench import bench_shard

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS = 2_000
LIVE_KW = dict(batch=8, n_batches=2, n_write=128)


def tree(x):
    """A report's keys, nested, with every leaf as None."""
    return {k: tree(v) for k, v in x.items()} if isinstance(x, dict) else None


@pytest.fixture(scope="module")
def stores():
    tb_j = jax_generator.make_testbed("SOM", ROWS, 0.75, n_poms=2, seed=0)
    tb_t = generator.make_testbed("SOM", ROWS, 0.75, n_poms=2, seed=0)
    js = jax_create_kg(tb_j.doc, tables={"csv:child.csv": tb_j.child}).to_store()
    ts = create_kg(tb_t.doc, tables={"csv:child.csv": tb_t.child},
                   device="cpu").to_store(device="cpu")
    assert (js.n_triples, js.n_terms) == (ts.n_triples, ts.n_terms)
    return js, ts


@pytest.fixture(scope="module")
def live_reports(stores):
    js, ts = stores
    return jax_bench_live(js, **LIVE_KW), bench_live(ts, **LIVE_KW)


@pytest.fixture(scope="module")
def shard_reports(stores):
    js, ts = stores
    return jax_bench_shard(js, n_queries=8), bench_shard(ts, n_queries=8)


def test_live_report_counts_match_jax(live_reports):
    want, got = live_reports
    assert tree(got) == tree(want)
    committed = tree(json.loads((ROOT / "BENCH_live.json").read_text()))
    assert tree({**got, "testbed_rows": 0}) == committed
    for key in ("n_triples", "n_terms"):
        assert got[key] == want[key]
    for op in ("insert", "delete"):
        assert got["write"][op]["rows"] == want["write"][op]["rows"] == LIVE_KW["n_write"]
    for label, q in got["query"].items():
        for key in ("n_queries", "warm_matches", "delta_fraction"):
            assert q[key] == want["query"][label][key], (label, key)
    assert got["query"]["delta10pct"]["delta_fraction"] > 0
    assert got["compaction"]["triples"] == want["compaction"]["triples"]


def test_shard_report_counts_match_jax(shard_reports):
    want, got = shard_reports
    assert tree(got) == tree(want)
    committed = tree(json.loads((ROOT / "BENCH_shard.json").read_text()))
    assert tree({**got, "testbed_rows": 0}) == committed
    assert got["fanout"] == want["fanout"]
    for name, cls in got["classes"].items():
        assert cls["query"] == want["classes"][name]["query"]
        for config, leaf in cls["configs"].items():
            want_leaf = want["classes"][name]["configs"][config]
            assert leaf["n_queries"] == want_leaf["n_queries"]
            assert leaf["fanout_per_query"] == want_leaf["fanout_per_query"], (name, config)
    for n in (2, 4):
        assert got["classes"]["routed_single"]["configs"][f"shards{n}"]["fanout_per_query"] == 1.0
        assert got["classes"]["scatter_bgp3"]["configs"][f"shards{n}"]["fanout_per_query"] == n


def _reports_in_root() -> dict:
    """The JAX package's committed reports in the repo root, with their
    modification times."""
    return {p.name: p.stat().st_mtime_ns for p in ROOT.glob("*.json")}


def test_runner_writes_only_into_json_dir(tmp_path, monkeypatch, capsys):
    """``--only dedup`` and ``--only live`` (at 2K rows) on the CPU: CSV
    rows on stdout, ``BENCH_live.json`` with the committed keys in the
    given directory, nothing in the working directory or the repo root."""
    cwd, out = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(runner, "ROWS_SMALL", ROWS)
    root_before = _reports_in_root()
    runner.main(["--device", "cpu", "--only", "dedup", "--json-dir", str(out)])
    runner.main(["--device", "cpu", "--only", "live", "--json-dir", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert "# device: cpu (cpu)" in lines
    assert [ln.split(",")[0] for ln in lines if ln.startswith("dedup/")] == [
        "dedup/x1", "dedup/x8", "dedup/x64"]
    assert any(ln.startswith("live/query-delta10pct,") for ln in lines)
    assert os.listdir(cwd) == [] and _reports_in_root() == root_before
    assert os.listdir(out) == ["BENCH_live.json"]
    report = json.loads((out / "BENCH_live.json").read_text())
    assert report["testbed_rows"] == ROWS
    assert tree(report) == tree(json.loads((ROOT / "BENCH_live.json").read_text()))


def test_runner_defaults(monkeypatch):
    args = runner.parser().parse_args([])
    assert (args.device, args.json_dir, args.full, args.only) == (
        "cuda", os.path.join("bench-out", "torch"), False, None)
    called = []
    monkeypatch.setattr(runner, "bench_dedup_gather", called.append)
    monkeypatch.setattr(runner.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner.main(["--only", "dedup"])
    assert called == []


ENTRY_POINTS = {
    "make_sharded_ptt": lambda: distributed.make_sharded_ptt(8, 64).hi,
    "WideDeep": lambda: WideDeep(wide_deep.smoke_config()).embed,
    "bench.dedup_gather.run": lambda: dedup_gather.run(vocab=16, dim=2, n=8, dup_factors=(1,),
                                                       log=False),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_new_entry_points_default_to_the_card(name):
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        out = ENTRY_POINTS[name]()
        assert not isinstance(out, torch.Tensor) or out.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            ENTRY_POINTS[name]()

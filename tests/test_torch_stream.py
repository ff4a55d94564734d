"""The port's stream package and streamed engine against the JAX package.

The readers must give the same Blocks as ``repro.stream`` on the CSV, TSV,
JSON and glob sources of ``tests/test_stream.py``; the streamed engine
(``stream=True``) must write N-Triples byte-identical, unsorted, to the JAX
package's streamed run with the same ``block_rows``, with equal
``PredicateStats``, and its sorted lines must equal the port's eager run.
The engine runs with ``device="cpu"``, where every kernel wrapper takes its
plain version.
"""

import json

import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro.core.executor import create_kg as jax_create_kg
from repro.data.encoder import Dictionary as JDictionary
from repro.rml import generator
from repro_torch import stream
from repro_torch.core import executor
from repro_torch.core.executor import create_kg
from repro_torch.data.encoder import Dictionary
from repro_torch.rml import generator as torch_generator

N_ROWS = 2000
CASES = [(k, d, p) for k in ("SOM", "ORM", "OJM") for d in (0.25, 0.75) for p in (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps torch's CPU thread pools from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- readers


def _write(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def _rows(n):
    return "A\n" + "".join(f"{i}\n" for i in range(n))


# name -> (files to write, dataset from (stream package, Dictionary class, dir))
READERS = {
    **{
        f"csv_{n}_rows_blocks_of_{b}": (
            {"t.csv": _rows(n)},
            lambda s, D, d, b=b: s.read_csv(f"{d}/t.csv", block_rows=b),
        )
        for n, b in [(3, 8), (8, 8), (16, 8), (17, 8), (1, 1)]
    },
    "csv_empty": ({"e.csv": "A,B\n"}, lambda s, D, d: s.read_csv(f"{d}/e.csv", block_rows=4)),
    "csv_headerless": ({"n.csv": ""}, lambda s, D, d: s.read_csv(f"{d}/n.csv")),
    "csv_delimiter": ({"t.txt": "A;B\n1;x\n2;y\n"},
                      lambda s, D, d: s.read_csv(f"{d}/t.txt", delimiter=";")),
    "tsv": ({"t.tsv": "A\tB\n1\tx\n2\ty\n"},
            lambda s, D, d: s.read_source(f"{d}/t.tsv", fmt="tsv")),
    "csv_pushdown": ({"w.csv": "A,B,C\n1,x,p\n2,y,q\n3,z,r\n"},
                     lambda s, D, d: s.read_csv(f"{d}/w.csv", block_rows=2).project(
                         "C", "A", fill=None, pushdown=True)),
    "csv_encoded": ({"t.csv": "A\nx\ny\nx\nz\nx\n"},
                    lambda s, D, d: s.read_csv(f"{d}/t.csv", block_rows=2).encode(D())),
    "json_lines": (
        {"t.jsonl": "".join(json.dumps({"a": str(i), "b": str(i % 3)}) + "\n"
                            for i in range(11))},
        lambda s, D, d: s.read_json(f"{d}/t.jsonl", block_rows=4)),
    "json_iterator": (
        {"t.jsonl": json.dumps({"items": [{"v": "1"}, {"v": "2"}]}) + "\n"
         + json.dumps({"items": [{"v": "3"}]}) + "\n"},
        lambda s, D, d: s.read_json(f"{d}/t.jsonl", block_rows=2, iterator="$.items")),
    "json_heterogeneous": (
        {"t.jsonl": '{"a": "1"}\n{"a": "2", "b": "x"}\n{"b": "y", "c": "z"}\n'},
        lambda s, D, d: s.read_json(f"{d}/t.jsonl", block_rows=2).project("a", "b", "c")),
    "glob": (
        {f"part{i}.csv": f"A,B\n{i}a,{i}b\n{i}c,{i}d\n" for i in range(3)},
        lambda s, D, d: s.read_source(f"{d}/part*.csv", fmt="csv", block_rows=2)),
    "glob_heterogeneous": (
        {"s0.csv": "A,B\n1,2\n", "s1.csv": "A,C\n3,4\n"},
        lambda s, D, d: s.read_source(f"{d}/s*.csv", block_rows=4).project("A", "B", "C")),
    "table_rebatched": (
        {}, lambda s, D, d: s.Dataset.from_table(
            {"x": np.arange(25).astype(str).astype(object)}, block_rows=10).batch(4)),
}


def _blocks(ds):
    return [(b.schema, {c: b.columns[c].tolist() for c in b.schema},
             {c: str(b.columns[c].dtype) for c in b.schema}) for b in ds.iter_blocks()]


@pytest.mark.parametrize("case", sorted(READERS))
def test_stream_readers_match_jax(tmp_path, case):
    files, make = READERS[case]
    for name, text in files.items():
        _write(tmp_path / name, text)
    want = _blocks(make(jstream, JDictionary, tmp_path))
    got = _blocks(make(stream, Dictionary, tmp_path))
    assert got == want
    assert make(stream, Dictionary, tmp_path).count() == sum(
        len(next(iter(c.values()), [])) for _, c, _ in want)


def test_stream_glob_no_match_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope"):
        stream.read_source(str(tmp_path / "nope*.csv")).count()


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def testbeds(tmp_path_factory):
    """Each testbed written once by the JAX package's generator: (the JAX
    package's doc, the port's doc from its copy of the generator, data
    dir), keyed (kind, dup, n_poms, n_rows)."""
    out = {}
    for kind, dup, n_poms, n_rows in [(*c, N_ROWS) for c in CASES] + [
        ("SOM", 0.75, 2, 50), ("OJM", 0.75, 2, 50)
    ]:
        tb = generator.make_testbed(kind, n_rows, dup, n_poms=n_poms, seed=5)
        ttb = torch_generator.make_testbed(kind, n_rows, dup, n_poms=n_poms, seed=5)
        d = tmp_path_factory.mktemp(f"{kind}_{int(dup * 100)}_{n_poms}_{n_rows}")
        tb.write(str(d))
        out[(kind, dup, n_poms, n_rows)] = (tb.doc, ttb.doc, d)
    return out


def _stats(result):
    return {p: vars(s) for p, s in result.stats.items()}


def _both(bed, tmp_path, **cfg):
    jdoc, doc, d = bed
    want = jax_create_kg(jdoc, data_root=str(d), stream=True, **cfg)
    got = create_kg(doc, data_root=str(d), device="cpu", stream=True, **cfg)
    want.write_ntriples(str(tmp_path / "jax.nt"))
    got.write_ntriples(str(tmp_path / "torch.nt"))
    assert got.engine == "stream"
    return want, got, (tmp_path / "jax.nt").read_bytes(), (tmp_path / "torch.nt").read_bytes()


@pytest.mark.parametrize("kind,dup,n_poms", CASES)
def test_streamed_ntriples_byte_identical(testbeds, tmp_path, kind, dup, n_poms):
    bed = testbeds[(kind, dup, n_poms, N_ROWS)]
    want, got, wb, gb = _both(bed, tmp_path)
    assert gb == wb and got.n_triples == want.n_triples > 0
    assert _stats(got) == _stats(want)
    eager = create_kg(bed[1], data_root=str(bed[2]), device="cpu")
    assert sorted(got.iter_ntriples()) == sorted(eager.iter_ntriples())


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
@pytest.mark.parametrize("block_rows", [64, 256, 4096])
def test_streamed_block_sizes_byte_identical(testbeds, tmp_path, kind, block_rows):
    want, got, wb, gb = _both(testbeds[(kind, 0.75, 2, N_ROWS)], tmp_path,
                              block_rows=block_rows)
    assert gb == wb and _stats(got) == _stats(want)


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_streamed_one_row_blocks_byte_identical(testbeds, tmp_path, kind):
    want, got, wb, gb = _both(testbeds[(kind, 0.75, 2, 50)], tmp_path, block_rows=1)
    assert gb == wb and got.n_triples > 0 and _stats(got) == _stats(want)


@pytest.mark.parametrize("kind", ["SOM", "ORM", "OJM"])
def test_streamed_planner_off_byte_identical(testbeds, tmp_path, kind):
    want, got, wb, gb = _both(testbeds[(kind, 0.75, 2, N_ROWS)], tmp_path,
                              mapping_plan=False, block_rows=300)
    assert gb == wb and _stats(got) == _stats(want)


@pytest.mark.parametrize("dup", [0.25, 0.75])
def test_streamed_hash_join_byte_identical(testbeds, tmp_path, dup):
    want, got, wb, gb = _both(testbeds[("OJM", dup, 2, N_ROWS)], tmp_path,
                              join_strategy="hash", block_rows=512)
    assert gb == wb and _stats(got) == _stats(want)


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_streamed_replays_on_overflow(testbeds, tmp_path, kind, monkeypatch):
    """A load factor far above 1 sizes every PTT too small: both engines
    overflow, double the capacity, re-read the source, and still agree."""
    made = []
    real = executor.ptt.make_capacity
    monkeypatch.setattr(executor.ptt, "make_capacity",
                        lambda cap, device: made.append(cap) or real(cap, device))
    want, got, wb, gb = _both(testbeds[(kind, 0.25, 2, N_ROWS)], tmp_path,
                              load_factor=16.0, block_rows=500)
    assert gb == wb and _stats(got) == _stats(want)
    assert len(made) > len(got.stats)  # some predicate was replayed


def test_streamed_times_its_block_reads(testbeds):
    _, doc, d = testbeds[("OJM", 0.25, 1, N_ROWS)]
    got = create_kg(doc, data_root=str(d), device="cpu", stream=True, block_rows=256)
    assert 0 < got.load_encode_s < got.wall_time_s


def test_stream_refuses_the_naive_engine_and_bad_blocks(testbeds):
    _, doc, d = testbeds[("SOM", 0.25, 1, N_ROWS)]
    with pytest.raises(ValueError, match="only the optimized engine"):
        create_kg(doc, data_root=str(d), device="cpu", stream=True, engine="naive")
    with pytest.raises(ValueError, match="block_rows"):
        create_kg(doc, data_root=str(d), device="cpu", stream=True, block_rows=0)

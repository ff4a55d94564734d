"""The port's eager engines and rdfize CLI against the JAX package.

The written N-Triples must be byte-identical, unsorted (emission order
follows the ``is_new`` lanes, or the naive engine's join lanes), over the
paper's testbeds, for the optimized engine with either PJTT and for the
naive engine; the engine runs with ``device="cpu"``, where every kernel
wrapper takes its plain version.  The streamed engine is in
``test_torch_stream.py``.
Also here: the port imports nothing of JAX, the card is the default device
and asking for it without one raises.
"""

import ast
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro.core.executor import create_kg as jax_create_kg
from repro.launch import rdfize as jax_rdfize
from repro.rml import generator, serializer
from repro.rml import parser as jax_parser
from repro_torch.core import executor
from repro_torch.core.executor import EngineConfig, create_kg
from repro_torch.kernels import bucket_dedup, hash_mix, nested_join
from repro_torch.launch import rdfize
from repro_torch.rml import generator as torch_generator
from repro_torch.rml import parser as torch_parser

ROOT = pathlib.Path(__file__).resolve().parents[1]
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


@pytest.fixture(scope="module")
def testbeds(tmp_path_factory):
    """Each testbed written once by the JAX package's generator:
    (the JAX package's doc, the port's doc, data dir).  The port's copy of
    the generator makes the same tables."""
    out = {}
    for kind, dup, n_poms in CASES:
        tb = generator.make_testbed(kind, N_ROWS, dup, n_poms=n_poms, seed=5)
        ttb = torch_generator.make_testbed(kind, N_ROWS, dup, n_poms=n_poms, seed=5)
        for name, col in tb.child.items():
            assert (ttb.child[name] == col).all()
        d = tmp_path_factory.mktemp(f"{kind}_{int(dup * 100)}_{n_poms}")
        tb.write(str(d))
        serializer.write_turtle(tb.doc, str(d / "map.ttl"))
        out[(kind, dup, n_poms)] = (tb.doc, ttb.doc, d)
    return out


def _stats(result):
    return {p: vars(s) for p, s in result.stats.items()}


def _both(docs, d, tmp_path, **cfg):
    want = jax_create_kg(docs[0], data_root=str(d), **cfg)
    got = create_kg(docs[1], data_root=str(d), device="cpu", **cfg)
    want.write_ntriples(str(tmp_path / "jax.nt"))
    got.write_ntriples(str(tmp_path / "torch.nt"))
    return want, got, (tmp_path / "jax.nt").read_bytes(), (tmp_path / "torch.nt").read_bytes()


@pytest.mark.parametrize("kind,dup,n_poms", CASES)
def test_create_kg_ntriples_byte_identical(testbeds, tmp_path, kind, dup, n_poms):
    *docs, d = testbeds[(kind, dup, n_poms)]
    want, got, wb, gb = _both(docs, d, tmp_path)
    assert gb == wb and got.n_triples == want.n_triples > 0
    assert _stats(got) == _stats(want)


@pytest.mark.parametrize("kind,dup,n_poms", CASES)
def test_naive_engine_ntriples_byte_identical(testbeds, tmp_path, kind, dup, n_poms):
    *docs, d = testbeds[(kind, dup, n_poms)]
    nested_join.launches = 0
    want, got, wb, gb = _both(docs, d, tmp_path, engine="naive")
    assert nested_join.launches == 0  # the CPU runs the plain join
    assert gb == wb and got.n_triples == want.n_triples > 0
    assert _stats(got) == _stats(want) and got.engine == "naive"
    if kind == "OJM":
        assert all(s.n_parent == s.n_child == N_ROWS for s in got.stats.values()
                   if s.kind == "OJM")
    optimized = create_kg(docs[1], data_root=str(d), device="cpu")
    assert sorted(got.iter_ntriples()) == sorted(optimized.iter_ntriples())


@pytest.mark.parametrize("dup", [0.25, 0.75])
@pytest.mark.parametrize("n_poms", [1, 2])
def test_hash_join_ntriples_byte_identical(testbeds, tmp_path, dup, n_poms):
    *docs, d = testbeds[("OJM", dup, n_poms)]
    want, got, wb, gb = _both(docs, d, tmp_path, join_strategy="hash")
    assert gb == wb and _stats(got) == _stats(want)


def test_naive_engine_planner_off_byte_identical(testbeds, tmp_path):
    *docs, d = testbeds[("OJM", 0.75, 2)]
    want, got, wb, gb = _both(docs, d, tmp_path, engine="naive", mapping_plan=False)
    assert gb == wb and _stats(got) == _stats(want)


def test_naive_engine_raises_when_the_join_is_truncated(testbeds):
    *docs, d = testbeds[("OJM", 0.75, 1)]
    with pytest.raises(RuntimeError, match="max_matches"):
        create_kg(docs[1], data_root=str(d), device="cpu", engine="naive", max_matches=1)


@pytest.mark.parametrize("kind", ["SOM", "ORM", "OJM"])
def test_create_kg_planner_off_byte_identical(testbeds, tmp_path, kind):
    *docs, d = testbeds[(kind, 0.75, 2)]
    want, got, wb, gb = _both(docs, d, tmp_path, mapping_plan=False)
    assert gb == wb and _stats(got) == _stats(want)


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_create_kg_replays_on_overflow(testbeds, tmp_path, kind, monkeypatch):
    """A load factor far above 1 sizes every PTT too small: both engines
    overflow, double the capacity, replay, and still agree."""
    *docs, d = testbeds[(kind, 0.25, 2)]
    made = []
    real = executor.ptt.make_capacity
    monkeypatch.setattr(executor.ptt, "make_capacity",
                        lambda cap, device: made.append(cap) or real(cap, device))
    want, got, wb, gb = _both(docs, d, tmp_path, load_factor=16.0)
    assert gb == wb and _stats(got) == _stats(want)
    assert len(made) > len(got.stats)  # some predicate was replayed


def test_create_kg_small_batches_byte_identical(testbeds, tmp_path):
    *docs, d = testbeds[("OJM", 0.25, 1)]
    want, got, wb, gb = _both(docs, d, tmp_path, batch_size=256)
    assert gb == wb


# A hand-written mapping (the shape of test_mapping_plan.py's WIDE_TTL), with
# what make_testbed never emits: rr:class on two maps (the rdf:type triples,
# the most duplicated keys the PTT sees), literal and IRI rr:constant
# objects, a template of two placeholders, a join, and a third map whose
# source is CSV or JSON lines.
HAND_TTL = """
@prefix rr: <http://www.w3.org/ns/r2rml#> .
@prefix rml: <http://semweb.mmlab.be/ns/rml#> .
@prefix ql: <http://semweb.mmlab.be/ns/ql#> .
@prefix ex: <http://example.com/> .

ex:GeneMap a rr:TriplesMap ;
  rml:logicalSource [ rml:source "gene.csv" ; rml:referenceFormulation ql:CSV ] ;
  rr:subjectMap [ rr:template "http://example.com/gene/{GENE_ID}" ; rr:class ex:Gene ] ;
  rr:predicateObjectMap [ rr:predicate ex:name ; rr:objectMap [ rml:reference "GENE_NAME" ] ] ;
  rr:predicateObjectMap [ rr:predicate ex:label ;
    rr:objectMap [ rr:template "http://example.com/lbl/{GENE_ID}/{GENE_NAME}" ] ] ;
  rr:predicateObjectMap [ rr:predicate ex:curation ; rr:objectMap [ rr:constant "curated" ] ] .

ex:MutMap a rr:TriplesMap ;
  rml:logicalSource [ rml:source "mut.csv" ; rml:referenceFormulation ql:CSV ] ;
  rr:subjectMap [ rr:template "http://example.com/mut/{MUT_ID}" ; rr:class ex:Mutation ] ;
  rr:predicateObjectMap [ rr:predicate ex:inGene ;
    rr:objectMap [ rr:parentTriplesMap ex:GeneMap ;
                   rr:joinCondition [ rr:child "GENE" ; rr:parent "GENE_ID" ] ] ] .

ex:OtherMap a rr:TriplesMap ;
  rml:logicalSource [ rml:source "other.csv" ; rml:referenceFormulation ql:CSV ] ;
  rr:subjectMap [ rr:template "http://example.com/o/{OID}" ] ;
  rr:predicateObjectMap [ rr:predicate ex:val ; rr:objectMap [ rml:reference "V" ] ] ;
  rr:predicateObjectMap [ rr:predicate ex:kind ; rr:objectMap [ rr:constant ex:Other ] ] .
"""


def _write_hand_testbed(out_dir, fmt, n_genes=150, n_muts=600, n_other=300, seed=3):
    """Rows with repeats (genes listed twice, mutations hitting the same
    gene, a few values) so every predicate sees duplicates; other.* as CSV
    or as JSON lines."""
    rng = np.random.default_rng(seed)
    genes = [(f"g{i % n_genes}", f"name{i % 37}") for i in range(2 * n_genes)]
    (out_dir / "gene.csv").write_text(
        "GENE_ID,GENE_NAME\n" + "".join(f"{g},{nm}\n" for g, nm in genes))
    (out_dir / "mut.csv").write_text("MUT_ID,GENE\n" + "".join(
        f"m{rng.integers(0, n_muts // 2)},g{rng.integers(0, int(n_genes * 1.2))}\n"
        for _ in range(n_muts)))
    rows = [{"OID": f"o{rng.integers(0, n_other // 3)}", "V": f"v{i % 5}"}
            for i in range(n_other)]
    if fmt == "csv":
        (out_dir / "other.csv").write_text(
            "OID,V\n" + "".join(f"{r['OID']},{r['V']}\n" for r in rows))
        return HAND_TTL
    (out_dir / "other.json").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return HAND_TTL.replace('rml:source "other.csv" ; rml:referenceFormulation ql:CSV',
                            'rml:source "other.json" ; rml:referenceFormulation ql:JSONPath')


@pytest.mark.parametrize("cfg", [{}, {"engine": "naive"}, {"join_strategy": "hash"},
                                 {"stream": True, "block_rows": 128}],
                         ids=["optimized", "naive", "hash", "stream"])
@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_hand_written_mapping_byte_identical(tmp_path, fmt, cfg):
    ttl = _write_hand_testbed(tmp_path, fmt)
    want = jax_create_kg(jax_parser.parse(ttl), data_root=str(tmp_path), **cfg)
    got = create_kg(torch_parser.parse(ttl), data_root=str(tmp_path), device="cpu", **cfg)
    want.write_ntriples(str(tmp_path / "jax.nt"))
    got.write_ntriples(str(tmp_path / "torch.nt"))
    wb, gb = (tmp_path / "jax.nt").read_bytes(), (tmp_path / "torch.nt").read_bytes()
    assert gb == wb and _stats(got) == _stats(want)
    text = gb.decode()
    for needle in ("<http://example.com/Gene>", "<http://example.com/Mutation>",
                   '"curated"', "<http://example.com/Other>", "/lbl/g0/name0>",
                   "<http://example.com/inGene>"):
        assert needle in text
    # duplicates were dropped: every line once, fewer lines than the triples
    # the rows map to (4 a gene row, 2 a mutation row, 2 an other row)
    lines = text.splitlines()
    assert len(lines) == len(set(lines)) == got.n_triples < 4 * 300 + 2 * 600 + 2 * 300


def test_rdfize_cli_byte_identical(testbeds, tmp_path, monkeypatch, capsys):
    *_, d = testbeds[("OJM", 0.75, 2)]
    mapping = str(d / "map.ttl")
    monkeypatch.setattr(sys, "argv", ["rdfize", "--mapping", mapping, "--data-root",
                                      str(d), "--out", str(tmp_path / "jax.nt")])
    jax_rdfize.main()
    trace = tmp_path / "trace.json"
    result = rdfize.main(["--mapping", mapping, "--data-root", str(d), "--out",
                          str(tmp_path / "torch.nt"), "--device", "cpu",
                          "--trace", str(trace)])
    assert (tmp_path / "torch.nt").read_bytes() == (tmp_path / "jax.nt").read_bytes()
    assert result.n_triples > 0 and trace.stat().st_size > 0
    out = capsys.readouterr().out
    assert "unique triples" in out and "(optimized engine, cpu)" in out


def test_rdfize_explain_mapping_matches_jax(testbeds, monkeypatch, capsys):
    *_, d = testbeds[("ORM", 0.25, 2)]
    args = ["--mapping", str(d / "map.ttl"), "--data-root", str(d), "--explain-mapping"]
    monkeypatch.setattr(sys, "argv", ["rdfize", *args])
    jax_rdfize.main()
    want = capsys.readouterr().out
    assert rdfize.main(args) is None
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("flags", [["--engine", "naive"], ["--join", "hash"],
                                   ["--stream", "--block-rows", "700"]])
def test_rdfize_cli_slice_two_flags_byte_identical(testbeds, tmp_path, monkeypatch,
                                                    capsys, flags):
    *_, d = testbeds[("OJM", 0.25, 2)]
    common = ["--mapping", str(d / "map.ttl"), "--data-root", str(d)]
    monkeypatch.setattr(sys, "argv", ["rdfize", *common, "--out",
                                      str(tmp_path / "jax.nt"), *flags])
    jax_rdfize.main()
    result = rdfize.main([*common, "--out", str(tmp_path / "torch.nt"),
                          "--device", "cpu", *flags])
    assert (tmp_path / "torch.nt").read_bytes() == (tmp_path / "jax.nt").read_bytes()
    assert result.n_triples > 0
    engine = {"--engine": "naive", "--stream": "stream"}.get(flags[0], "optimized")
    assert f"({engine} engine, cpu)" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--emit", "kgz", "--shards", "2"],
                                   ["--emit", "kgz", "--shards", "3", "--shard-workers", "2"],
                                   ["--emit", "kgz", "--shards", "2", "--stream"]])
def test_rdfize_shard_flags_byte_identical(testbeds, tmp_path, monkeypatch, capsys, flags):
    """``--shards N`` (serial, or its shard stores built in spawned workers
    on the CPU) writes the JAX CLI's manifest and shard ``.kgz`` bytes."""
    *_, d = testbeds[("OJM", 0.25, 2)]
    common = ["--mapping", str(d / "map.ttl"), "--data-root", str(d), *flags]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.setattr(sys, "argv", ["rdfize", *common, "--out",
                                      str(tmp_path / "jax" / "kg.shards.json")])
    jax_rdfize.main()
    capsys.readouterr()
    result = rdfize.main([*common, "--out", str(tmp_path / "torch" / "kg.shards.json"),
                          "--device", "cpu"])
    assert result.n_triples > 0
    n = int(flags[flags.index("--shards") + 1])
    names = ["kg.shards.json"] + [f"kg.shard{i}.kgz" for i in range(n)]
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name
    assert f"({n} shards: " in capsys.readouterr().out


def test_rdfize_shards_need_kgz_as_in_jax(testbeds, monkeypatch, capsys):
    *_, d = testbeds[("SOM", 0.25, 1)]
    args = ["--mapping", str(d / "map.ttl"), "--shards", "2"]
    monkeypatch.setattr(sys, "argv", ["rdfize", *args])
    with pytest.raises(SystemExit) as want:
        jax_rdfize.main()
    jerr = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        rdfize.main([*args, "--device", "cpu"])
    err = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert err.split("error: ")[1] == jerr.split("error: ")[1] == (
        "--shards needs --emit kgz (shard stores are .kgz snapshots)")


def test_the_card_is_the_default_device(testbeds, monkeypatch):
    assert EngineConfig().device == "cuda"
    *_, d = testbeds[("SOM", 0.25, 1)]
    seen = {}

    def fake_create_kg(doc, **config):
        seen.update(config)
        raise SystemExit(0)

    monkeypatch.setattr(executor, "create_kg", fake_create_kg)
    with pytest.raises(SystemExit):
        rdfize.main(["--mapping", str(d / "map.ttl"), "--data-root", str(d)])
    assert seen["device"] == "cuda"


def test_asking_for_cuda_without_a_card_raises(testbeds, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, doc, d = testbeds[("SOM", 0.25, 1)]
    hash_mix.launches = bucket_dedup.launches = nested_join.launches = 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_kg(doc, data_root=str(d))  # the default device
    for cfg in (dict(engine="naive"), dict(stream=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_kg(doc, data_root=str(d), **cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rdfize.main(["--mapping", str(d / "map.ttl"), "--data-root", str(d),
                     "--out", str(tmp_path / "x.nt")])
    assert not (tmp_path / "x.nt").exists()
    assert hash_mix.launches == bucket_dedup.launches == nested_join.launches == 0


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


# the serving slice's modules, which the guards below must cover
SERVING = ("kg/store.py", "kg/persist.py", "kg/query.py", "kg/bench.py",
           "serve/values.py", "serve/algebra.py", "serve/plan.py", "serve/oracle.py",
           "serve/exec.py", "serve/fastpath.py", "serve/bench.py",
           "kernels/scan_join.py", "api/__init__.py", "api/errors.py",
           "launch/query.py", "live/__init__.py", "live/delta.py",
           "serve/server.py", "serve/client.py", "launch/serve.py",
           "shard/__init__.py", "shard/partition.py", "shard/ingest.py",
           "shard/merge.py", "shard/coordinator.py", "bench/paper_figs.py",
           "bench/op_model.py", "bench/shard_gather.py", "live/bench.py",
           "shard/bench.py", "core/dedup_gather.py", "core/distributed.py",
           "bench/dedup_gather.py", "bench/run.py", "models/__init__.py",
           "models/layers.py", "models/recsys.py", "configs/__init__.py",
           "configs/wide_deep.py", "configs/registry.py")


def test_port_imports_nothing_of_jax_or_repro():
    files = sorted((ROOT / "src/repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    rel = {p.relative_to(ROOT / "src/repro_torch").as_posix() for p in files[:-1]}
    assert set(SERVING) <= rel
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), f"{path} imports {name}"


def test_every_port_module_imports_first():
    """Each module imports cleanly as the first module of the package a
    process loads (an import cycle shows only in some orders)."""
    import subprocess

    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "src/repro_torch").rglob("*.py")
    )
    assert {"repro_torch." + m.removesuffix(".py").replace("/", ".").removesuffix(".__init__")
            for m in SERVING} <= set(mods)
    code = (
        "import sys, importlib, torch\n"
        f"for m in {mods!r}:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro', 'benchmarks') for k in sys.modules)\n"
    )
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr

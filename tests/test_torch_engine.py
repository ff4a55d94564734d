"""The port's eager engine and rdfize CLI against the JAX package.

The written N-Triples must be byte-identical, unsorted (emission order
follows the ``is_new`` lanes), over the paper's testbeds; the engine runs
with ``device="cpu"``, where every kernel wrapper takes its plain version.
Also here: the port imports nothing of JAX, the card is the default device
and asking for it without one raises.
"""

import ast
import pathlib
import sys

import pytest
import torch

from repro.core.executor import create_kg as jax_create_kg
from repro.launch import rdfize as jax_rdfize
from repro.rml import generator, serializer
from repro_torch.core import executor
from repro_torch.core.executor import EngineConfig, create_kg
from repro_torch.kernels import bucket_dedup, hash_mix
from repro_torch.launch import rdfize
from repro_torch.rml import generator as torch_generator

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


@pytest.mark.parametrize("flags", [["--stream"], ["--block-rows", "128"], ["--engine", "naive"],
                                   ["--join", "hash"], ["--emit", "kgz"],
                                   ["--emit", "kgz", "--shards", "2"], ["--shard-workers", "2"]])
def test_rdfize_later_slice_flags_exit_with_an_error(testbeds, flags, capsys):
    *_, d = testbeds[("SOM", 0.25, 1)]
    with pytest.raises(SystemExit) as e:
        rdfize.main(["--mapping", str(d / "map.ttl"), "--device", "cpu", *flags])
    assert e.value.code == 2 and "slice 2" in capsys.readouterr().err


@pytest.mark.parametrize("cfg", [dict(stream=True), dict(engine="naive"),
                                 dict(join_strategy="hash")])
def test_engine_later_slice_options_raise(testbeds, cfg):
    _, doc, d = testbeds[("SOM", 0.25, 1)]
    with pytest.raises(ValueError, match="slice 2"):
        create_kg(doc, data_root=str(d), device="cpu", **cfg)


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
    hash_mix.launches = bucket_dedup.launches = 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_kg(doc, data_root=str(d))  # the default device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rdfize.main(["--mapping", str(d / "map.ttl"), "--data-root", str(d),
                     "--out", str(tmp_path / "x.nt")])
    assert not (tmp_path / "x.nt").exists()
    assert hash_mix.launches == bucket_dedup.launches == 0


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_nothing_of_jax_or_repro():
    files = sorted((ROOT / "src/repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def test_every_port_module_imports_first():
    """Each module imports cleanly as the first module of the package a
    process loads (an import cycle shows only in some orders)."""
    import subprocess

    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "src/repro_torch").rglob("*.py")
    )
    code = (
        "import sys, importlib, torch\n"
        f"for m in {mods!r}:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro') for k in sys.modules)\n"
    )
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr

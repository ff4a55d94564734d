"""The port's KG examples (``repro_torch.examples.quickstart`` and
``kg_biomedical``) against the JAX package's ``examples/`` on the CPU:
every printed line equals the JAX example's once the times (and
quickstart's temporary directory) are masked: the counts, φ ratios, the
mapping and its plan, and the first triples."""

import os
import re
import runpy
import sys

import pytest
import torch

from repro_torch.examples import kg_biomedical, quickstart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name, argv, capsys, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    runpy.run_path(os.path.join(ROOT, "examples", name), run_name="__main__")
    return capsys.readouterr().out


def _masked(text: str) -> list[str]:
    """The lines with every time (``0.12s``) and time ratio (the naive
    line's speedup, ``1.05x``) masked, and the temporary directory."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"\s*\d+\.\d+s\b", " <s>", line)  # its padding too
        line = re.sub(r"(<s>\s+\d+)\s+\d+\.\d+x$", r"\1  <x>", line)
        line = re.sub(r"mapping written to \S+", "mapping written to <tmp>", line)
        out.append(line)
    return out


def test_quickstart_prints_what_jax_prints(capsys, monkeypatch):
    want = _masked(_jax_example("quickstart.py", [], capsys, monkeypatch))
    quickstart.main(["--device", "cpu"])
    got = _masked(capsys.readouterr().out)
    assert got == want
    assert any("|N_p|=" in line for line in got) and "first three triples:" in got
    assert sum(1 for line in got if line.startswith("  <")) >= 3  # the triples


@pytest.mark.parametrize("rows,dup,poms", [(3000, 0.75, 2), (2000, 0.25, 1)])
def test_kg_biomedical_prints_what_jax_prints(rows, dup, poms, capsys, monkeypatch):
    argv = ["--rows", str(rows), "--dup", str(dup), "--n-poms", str(poms)]
    want = _masked(_jax_example("kg_biomedical.py", argv, capsys, monkeypatch))
    results = kg_biomedical.main([*argv, "--device", "cpu"])
    got = _masked(capsys.readouterr().out)
    assert got == want
    assert sum("phi ratio" in line for line in got) == 3 * poms  # SOM, ORM, OJM
    for kind, (opt, nav) in results.items():
        assert opt.n_triples == nav.n_triples > 0, kind


def test_kg_examples_need_a_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default runs")
    for main in (quickstart.main, kg_biomedical.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])

"""repro_torch.bench (the paper's Figures 5 and 6 and the §III.iv
operation-count model) against ``benchmarks/paper_figs.py`` and
``benchmarks/op_model.py`` at 10K rows on the CPU: every cell's triple
count and per-predicate φ statistics are equal, exactly."""

import pytest
import torch

from benchmarks import op_model as jax_op_model
from benchmarks import paper_figs as jax_paper_figs
from repro_torch.bench import op_model, paper_figs

N_ROWS = 10_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_poms", [1, 2])
@pytest.mark.parametrize("dup", [0.25, 0.75])
@pytest.mark.parametrize("kind", ["SOM", "ORM", "OJM"])
def test_run_cell_matches_jax(kind, dup, n_poms):
    tb = paper_figs._testbed(kind, N_ROWS, dup, n_poms)
    for engine in ("optimized", "naive"):
        want = jax_paper_figs.run_cell(kind, N_ROWS, dup, n_poms, engine)
        got = paper_figs.run_cell(kind, N_ROWS, dup, n_poms, engine, device="cpu", tb=tb)
        assert got["status"] == want["status"] == "ok"
        assert got["n_triples"] == want["n_triples"] > 0
        assert got["stats"] == want["stats"]
        assert got["time_s"] > 0


def test_sweep_rows_and_the_cpu_budget():
    rows = paper_figs.sweep(sizes=(2_000,), dups=(0.75,), kinds=("OJM",),
                            n_poms_list=(1,), device="cpu", log=False)
    assert [(r["engine"], r["status"], r["device"]) for r in rows] == [
        ("optimized", "ok", "cpu"), ("naive", "ok", "cpu")]
    assert rows[0]["n_triples"] == rows[1]["n_triples"]
    assert rows[0]["stats"] == jax_paper_figs.run_cell("OJM", 2_000, 0.75, 1, "optimized")["stats"]
    # the JAX package's budget marks the paper's 1M naive OJM cell DNF on
    # the CPU (on the card it runs)
    big = paper_figs.run_cell("OJM", 1_000_000, 0.75, 1, "naive", device="cpu")
    assert big == jax_paper_figs.run_cell("OJM", 1_000_000, 0.75, 1, "naive")


def test_op_model_matches_jax():
    got = op_model.run(sizes=(N_ROWS,), device="cpu", log=False)
    want = jax_op_model.run(sizes=(N_ROWS,))
    assert got == want and len(got) == 6

"""repro_torch.core.dedup_gather against repro.core.dedup_gather.

The same numpy-seeded table and id streams go through both on the CPU.
``values``, ``n_unique`` and ``overflowed`` must be bit-equal, over
duplicate factors 1, 4 and 64, a cap below the distinct count (overflow:
the values are then wrong on both sides, and wrong the same way), one id
repeated and a single lane.  The gradient with respect to the table is
held against ``jax.grad`` within rtol 1e-6 and atol 1e-6: both are
scatter-adds of the same lanes, whose summation order may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dedup_gather as jdg
from repro_torch.core import dedup_gather as tdg

V, D = 500, 8


def _case(n, n_distinct, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.choice(rng.permutation(V)[:n_distinct], size=n).astype(np.int32)
    return table, ids


CASES = {
    # name: (n, n_distinct, cap)
    "dup1": (256, 256, 384),
    "dup4": (256, 64, 96),
    "dup64": (1024, 16, 24),
    "overflow": (256, 200, 64),
    "all_same": (64, 1, 4),
    "one_lane": (1, 1, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dedup_gather_bit_equal(name):
    n, n_distinct, cap = CASES[name]
    table, ids = _case(n, n_distinct, seed=len(name))
    want = jdg.dedup_gather(jnp.asarray(table), jnp.asarray(ids), cap)
    got = tdg.dedup_gather(torch.from_numpy(table), torch.from_numpy(ids), cap)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.n_unique.dtype == torch.int32 and got.n_unique.dim() == 0
    assert got.overflowed.dtype == torch.bool and got.overflowed.dim() == 0
    assert int(got.n_unique) == int(want.n_unique) == len(np.unique(ids))
    assert bool(got.overflowed) == bool(want.overflowed) == (name == "overflow")
    if name != "overflow":
        np.testing.assert_array_equal(got.values.numpy(), table[ids])


@pytest.mark.parametrize("cap", [None, 96])
def test_gather_maybe_dedup(cap):
    table, ids = _case(256, 64, seed=5)
    want = jdg.gather_maybe_dedup(jnp.asarray(table), jnp.asarray(ids), cap)
    got = tdg.gather_maybe_dedup(torch.from_numpy(table), torch.from_numpy(ids), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["dup4", "dup64", "overflow"])
def test_gradient_matches_jax(name):
    """d(sum(values * w))/d(table): the mirrored scatter-add (rtol 1e-6,
    atol 1e-6)."""
    n, n_distinct, cap = CASES[name]
    table, ids = _case(n, n_distinct, seed=11)
    w = np.random.default_rng(12).normal(size=(n, D)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jdg.dedup_gather(t, jnp.asarray(ids), cap).values * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    (tdg.dedup_gather(t, torch.from_numpy(ids), cap).values * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-6)

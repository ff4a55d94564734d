"""repro_torch.core.distributed (the shuffle PTT/PJTT) against
repro.core.distributed on an 8-device (4, 2) mesh, in both of the port's
arms: the shards stacked on one device (``n_shards=8``), and one shard a
rank on 8 gloo ranks of a (4, 2) ``ProcessMesh``.

JAX runs in a subprocess with ``--xla_force_host_platform_device_count=8``,
as ``tests/test_distributed.py`` does, so this process keeps one CPU device;
it writes its inputs and outputs to an ``.npz``.  The port runs the same
inputs on the CPU; the ranks are spawned once for the module, run every
case and gather their blocks (``sharding.gather_block``).  Every comparison
is bit-exact: the PTT words, ``is_new`` and the overflow flag after each of
two batches, the PJTT's sorted keys and subjects, and the probe's subjects,
mask and flag.  The ranks' mesh positions are checked against JAX's once:
every all-to-all over the mesh's axis tuple rests on them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import u32_numpy, u32_tensor
from repro_torch.core import distributed, hashing, hashset
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import sharding

_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import hashing, distributed
from repro.compat import compat_make_mesh

mesh = compat_make_mesh((4, 2), ("data", "model"))
sh = NamedSharding(mesh, P(("data", "model")))
put = lambda a: jax.device_put(a, sh)
rng = np.random.default_rng(0)
out = {}

def ptt(tag, vals, cap_total, n_batches):
    hi, lo = (np.asarray(x) for x in hashing.mix64([jnp.asarray(vals)]))
    valid = rng.random(len(vals)) < 0.9
    out[tag + "_hi_in"], out[tag + "_lo_in"], out[tag + "_valid"] = hi, lo, valid
    table = distributed.make_sharded_ptt(mesh, cap_total)
    step = len(vals) // n_batches
    for b in range(n_batches):
        sl = slice(b * step, (b + 1) * step)
        table, is_new, ovf = distributed.distributed_insert(
            mesh, table, put(hi[sl]), put(lo[sl]), put(valid[sl]))
        out[f"{tag}_t{b}_hi"], out[f"{tag}_t{b}_lo"] = np.asarray(table.hi), np.asarray(table.lo)
        out[f"{tag}_t{b}_is_new"], out[f"{tag}_t{b}_ovf"] = np.asarray(is_new), np.asarray(ovf)

def pjtt(tag, pk, ps, ck, K):
    out[tag + "_pk"], out[tag + "_ps"], out[tag + "_ck"] = pk, ps, ck
    idx, ovf = distributed.build_distributed_pjtt(mesh, put(pk), put(ps))
    out[tag + "_skeys"], out[tag + "_ssubj"] = np.asarray(idx.skeys), np.asarray(idx.ssubj)
    out[tag + "_build_ovf"] = np.asarray(ovf)
    subs, valid, ovf = distributed.distributed_ojm_probe(mesh, idx, put(ck), K)
    out[tag + "_subs"], out[tag + "_pvalid"] = np.asarray(subs), np.asarray(valid)
    out[tag + "_probe_ovf"] = np.asarray(ovf)

ptt("ptt", rng.integers(0, 3000, 16384).astype(np.int32), 16384, 2)
# one key everywhere: every lane goes to one owner, far beyond BIN_SLACK
ptt("skew", np.full(4096, 7, np.int32), 8192, 1)
pk = rng.integers(0, 500, 8192).astype(np.int32)
pk[rng.random(8192) < 0.05] = -1          # invalid parent rows are not sent
pjtt("pj", pk, rng.integers(0, 100000, 8192).astype(np.int32),
     np.where(rng.random(8192) < 0.05, -1, rng.integers(0, 700, 8192)).astype(np.int32), 64)
# a probe span wider than K truncates
pjtt("trunc", rng.integers(0, 20, 4096).astype(np.int32),
     rng.integers(0, 100000, 4096).astype(np.int32),
     rng.integers(0, 30, 4096).astype(np.int32), 8)
# one parent key everywhere overflows the bins
pjtt("pskew", np.full(4096, 3, np.int32), np.arange(4096, dtype=np.int32),
     rng.integers(0, 8, 4096).astype(np.int32), 8)
# each device's (block, data index, model index) under P(("data", "model"))
from repro.compat import shard_map
pos = lambda x: jnp.stack([x[0], jax.lax.axis_index("data"), jax.lax.axis_index("model")])[None]
out["positions"] = np.asarray(jax.jit(shard_map(
    pos, mesh=mesh, in_specs=P(("data", "model")), out_specs=P(("data", "model")),
    check_vma=False))(jnp.arange(8, dtype=jnp.int32)))
np.savez(sys.argv[1], **out)
"""

S = 8


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist") / "jax.npz"
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.abspath(os.path.join(root, "src")))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(path)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


PTT_CASES = [("ptt", 2, 16384), ("skew", 1, 8192)]
PJTT_CASES = [("pj", 64), ("trunc", 8), ("pskew", 8)]


def _rank_cases(mesh, path):
    """Every case on this rank of the (4, 2) mesh: each global input's
    block in, the outputs' blocks gathered back (returned by rank 0; the
    flags by every rank)."""
    j = dict(np.load(path))
    spec = sharding.P(mesh.axis_names)

    def block(a):
        return sharding.local_block(torch.from_numpy(np.ascontiguousarray(a)), spec, mesh)

    def whole(t):
        return sharding.gather_block(t, spec, mesh).numpy()

    out, flags = {}, {}
    for tag, n_batches, cap_total in PTT_CASES:
        hi, lo = j[tag + "_hi_in"].view(np.int32), j[tag + "_lo_in"].view(np.int32)
        table = distributed.make_sharded_ptt(mesh, cap_total, device="cpu")
        step = hi.shape[0] // n_batches
        for b in range(n_batches):
            sl = slice(b * step, (b + 1) * step)
            table, is_new, ovf = distributed.distributed_insert(
                mesh, table, block(hi[sl]), block(lo[sl]), block(j[tag + "_valid"][sl]))
            out[f"{tag}_t{b}_hi"], out[f"{tag}_t{b}_lo"] = whole(table.hi), whole(table.lo)
            out[f"{tag}_t{b}_is_new"], flags[f"{tag}_t{b}_ovf"] = whole(is_new), bool(ovf)
    for tag, K in PJTT_CASES:
        idx, ovf = distributed.build_distributed_pjtt(
            mesh, block(j[tag + "_pk"]), block(j[tag + "_ps"]))
        out[tag + "_skeys"], out[tag + "_ssubj"] = whole(idx.skeys), whole(idx.ssubj)
        flags[tag + "_build_ovf"] = bool(ovf)
        subs, valid, ovf = distributed.distributed_ojm_probe(mesh, idx, block(j[tag + "_ck"]), K)
        out[tag + "_subs"], out[tag + "_pvalid"] = whole(subs), whole(valid)
        flags[tag + "_probe_ovf"] = bool(ovf)
    me = torch.tensor([[int(block(np.arange(S, dtype=np.int32))[0]), mesh.axis_index("data"),
                        mesh.axis_index("model")]], dtype=torch.int32)
    out["positions"] = whole(me)
    out["rank"] = torch.distributed.get_rank()
    return {"out": out if out["rank"] == 0 else None, "flags": flags, "rank": out["rank"]}


@pytest.fixture(scope="module")
def rank_out(jax_out, tmp_path_factory):
    path = tmp_path_factory.mktemp("ranks") / "inputs.npz"
    np.savez(path, **jax_out)
    res = run_ranks(_rank_cases, (4, 2), str(path), device="cpu", timeout=300)
    assert [r["rank"] for r in res] == list(range(S))
    # the flags are global: every rank holds the same
    assert all(r["flags"] == res[0]["flags"] for r in res)
    return {**res[0]["out"], **res[0]["flags"]}


def test_rank_positions_equal_jax(jax_out, rank_out):
    """Rank r sits at JAX's row-major mesh position of the device holding
    block r of ``P(("data", "model"))``."""
    np.testing.assert_array_equal(rank_out["positions"], jax_out["positions"])
    np.testing.assert_array_equal(rank_out["positions"][:, 0], np.arange(S))


@pytest.mark.parametrize("tag,n_batches,cap_total", PTT_CASES)
def test_rank_ptt_bit_equal_jax_and_stacked(jax_out, rank_out, tag, n_batches, cap_total):
    j, r = jax_out, rank_out
    hi, lo = u32_tensor(j[tag + "_hi_in"], "cpu"), u32_tensor(j[tag + "_lo_in"], "cpu")
    valid = _bool(j[tag + "_valid"])
    table = distributed.make_sharded_ptt(S, cap_total, device="cpu")
    step = hi.shape[0] // n_batches
    for b in range(n_batches):
        sl = slice(b * step, (b + 1) * step)
        table, is_new, ovf = distributed.distributed_insert(S, table, hi[sl], lo[sl], valid[sl])
        for key, stacked in (("hi", u32_numpy(table.hi)), ("lo", u32_numpy(table.lo))):
            got = r[f"{tag}_t{b}_{key}"].view(np.uint32)
            np.testing.assert_array_equal(got, j[f"{tag}_t{b}_{key}"])
            np.testing.assert_array_equal(got, stacked)
        np.testing.assert_array_equal(r[f"{tag}_t{b}_is_new"], j[f"{tag}_t{b}_is_new"])
        np.testing.assert_array_equal(r[f"{tag}_t{b}_is_new"], is_new.numpy())
        assert r[f"{tag}_t{b}_ovf"] == bool(j[f"{tag}_t{b}_ovf"]) == bool(ovf)
    assert r[f"{tag}_t{n_batches - 1}_ovf"] == (tag == "skew")


@pytest.mark.parametrize("tag,K", PJTT_CASES)
def test_rank_pjtt_and_probe_bit_equal_jax_and_stacked(jax_out, rank_out, tag, K):
    j, r = jax_out, rank_out
    idx, ovf = distributed.build_distributed_pjtt(S, _i32(j[tag + "_pk"]), _i32(j[tag + "_ps"]))
    subs, valid, povf = distributed.distributed_ojm_probe(S, idx, _i32(j[tag + "_ck"]), K)
    for key, stacked in (("skeys", idx.skeys), ("ssubj", idx.ssubj), ("subs", subs),
                         ("pvalid", valid)):
        np.testing.assert_array_equal(r[tag + "_" + key], j[tag + "_" + key])
        np.testing.assert_array_equal(r[tag + "_" + key], stacked.numpy())
    assert r[tag + "_build_ovf"] == bool(j[tag + "_build_ovf"]) == bool(ovf) == (tag == "pskew")
    assert r[tag + "_probe_ovf"] == bool(j[tag + "_probe_ovf"]) == bool(povf) == (tag != "pj")


def _bool(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, bool).copy())


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int32).copy())


@pytest.mark.parametrize("tag,n_batches,cap_total", PTT_CASES)
def test_sharded_ptt_bit_equal(jax_out, tag, n_batches, cap_total):
    j = jax_out
    hi, lo = u32_tensor(j[tag + "_hi_in"], "cpu"), u32_tensor(j[tag + "_lo_in"], "cpu")
    valid = _bool(j[tag + "_valid"])
    table = distributed.make_sharded_ptt(S, cap_total, device="cpu")
    assert table.hi.shape == j[f"{tag}_t0_hi"].shape
    step = hi.shape[0] // n_batches
    for b in range(n_batches):
        sl = slice(b * step, (b + 1) * step)
        table, is_new, ovf = distributed.distributed_insert(S, table, hi[sl], lo[sl], valid[sl])
        np.testing.assert_array_equal(u32_numpy(table.hi), j[f"{tag}_t{b}_hi"])
        np.testing.assert_array_equal(u32_numpy(table.lo), j[f"{tag}_t{b}_lo"])
        np.testing.assert_array_equal(is_new.numpy(), j[f"{tag}_t{b}_is_new"])
        assert bool(ovf) == bool(j[f"{tag}_t{b}_ovf"])
    assert bool(ovf) == (tag == "skew")


def test_sharded_ptt_matches_first_occurrence(jax_out):
    """``is_new`` over both batches is the first valid occurrence of each key."""
    j = jax_out
    keys = list(zip(j["ptt_hi_in"].tolist(), j["ptt_lo_in"].tolist()))
    seen, want = set(), []
    for k, v in zip(keys, j["ptt_valid"].tolist()):
        want.append(v and k not in seen)
        if v:
            seen.add(k)
    got = np.concatenate([j["ptt_t0_is_new"], j["ptt_t1_is_new"]])
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("tag,K", PJTT_CASES)
def test_sharded_pjtt_and_probe_bit_equal(jax_out, tag, K):
    j = jax_out
    idx, ovf = distributed.build_distributed_pjtt(S, _i32(j[tag + "_pk"]), _i32(j[tag + "_ps"]))
    np.testing.assert_array_equal(idx.skeys.numpy(), j[tag + "_skeys"])
    np.testing.assert_array_equal(idx.ssubj.numpy(), j[tag + "_ssubj"])
    assert bool(ovf) == bool(j[tag + "_build_ovf"]) == (tag == "pskew")
    subs, valid, povf = distributed.distributed_ojm_probe(S, idx, _i32(j[tag + "_ck"]), K)
    np.testing.assert_array_equal(subs.numpy(), j[tag + "_subs"])
    np.testing.assert_array_equal(valid.numpy(), j[tag + "_pvalid"])
    assert bool(povf) == bool(j[tag + "_probe_ovf"]) == (tag != "pj")


def test_probe_answers_the_join(jax_out):
    """Each valid child row's subject set is its key's parent subjects."""
    j = jax_out
    parents = {}
    for k, s in zip(j["pj_pk"].tolist(), j["pj_ps"].tolist()):
        if k >= 0:
            parents.setdefault(k, set()).add(s)
    idx, _ = distributed.build_distributed_pjtt(S, _i32(j["pj_pk"]), _i32(j["pj_ps"]))
    subs, valid, _ = distributed.distributed_ojm_probe(S, idx, _i32(j["pj_ck"]), 64)
    for row, k in enumerate(j["pj_ck"].tolist()):
        got = set(subs[row][valid[row]].tolist())
        assert got == (parents.get(k, set()) if k >= 0 else set())


def test_one_shard_equals_flat_insert():
    rng = np.random.default_rng(3)
    hi, lo = hashing.mix64([torch.from_numpy(rng.integers(0, 900, 2048).astype(np.int32))])
    valid = torch.from_numpy(rng.random(2048) < 0.8)
    table = distributed.make_sharded_ptt(1, 4096, device="cpu")
    flat = hashset.make(4096, device="cpu")
    for sl in (slice(0, 1024), slice(1024, 2048)):
        table, is_new, ovf = distributed.distributed_insert(1, table, hi[sl], lo[sl], valid[sl])
        res = hashset.insert_masked(flat, hi[sl], lo[sl], valid[sl])
        flat = res.table
        assert torch.equal(table.hi[0], flat.hi) and torch.equal(table.lo[0], flat.lo)
        assert torch.equal(is_new, res.is_new)
        assert bool(ovf) == bool(res.overflowed) is False


def test_uneven_split_raises():
    table = distributed.make_sharded_ptt(S, 64, device="cpu")
    key = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="equal shards"):
        distributed.distributed_insert(S, table, key, key, torch.ones(12, dtype=torch.bool))

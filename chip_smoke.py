#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. device and toolchain: the card's name and power limit, the torch,
     CUDA, nvcc and Triton versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
     source, started together) and time the build;
  3. make the paper's testbeds (SOM and OJM, two predicate-object maps,
     75% duplicates) at 100K and 1M rows, written as CSV with RML mappings;
  4. hold each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it, with exact equality (every output is
     an integer); after a warm-up, time the kernel on the device with
     ``torch.profiler`` and one wrapper call and the plain version with CUDA
     events; bound each by the bytes its input needs and by the operations
     it needs (K1: its compiled loop, read with ``cuobjdump -sass``);
  5. drive ``rdfize`` through ``repro_torch.launch.rdfize.main``: every
     testbed on the card with the kernels' launch counters set to 0 just
     before and read just after; then the 100K testbeds on the CPU, whose
     N-Triples must be byte-identical to the card's; the 1M outputs must hold
     no duplicate line and exactly the distinct triples a numpy count of the
     CSV gives; a profiled rerun of each 1M testbed gives the card's busy
     share over the whole run;
  6. print the kernels line (one JSON object), the card line, and last the
     result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.  Generated data
lives under ``build/chip_smoke/`` and is removed at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Integer rates of one SM per clock (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): 64 lanes of 32-bit add,
# logic, shift and compare on the ALU pipe; 64 of 32-bit multiply(-add)
# (IMAD), which issue to the FMA pipe; and four schedulers that issue one
# warp instruction a clock each.  Times the SM count and the card's highest
# SM clock, read in phase 1.
ALU_LANES, IMAD_LANES, ISSUE_LANES = 64, 64, 128
ALU_OPCODES = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IMNMX",
               "IABS", "POPC", "FLO", "BMSK", "PLOP3"}
OPS_PER_PROBE = 12  # K2: slot arithmetic, two shared loads, compares, claim
N_POMS, DUP = 2, 0.75
ROWS_SMALL, ROWS_PAPER = 100_000, 1_000_000  # the paper's 1M tier


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# ------------------------------------------------------------------ timing


def cuda_ms(fn, setup=None, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn(setup())`` on the card, by CUDA events; ``setup``
    (fresh inputs for a kernel that writes in place) runs outside them."""
    import torch

    for _ in range(warmup):
        fn(setup() if setup else None)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        args = setup() if setup else None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, setup=None, reps: int = 20):
    """Median device time of the kernel named ``kernel`` over ``reps``
    calls of ``fn(setup())``, from ``torch.profiler``'s CUDA activity;
    None when the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(setup() if setup else None)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(setup() if setup else None)
            torch.cuda.synchronize()
        events = prof.events()
    except Exception as e:  # a measurement the card could not give
        log(f"torch.profiler failed ({type(e).__name__}: {e}); device time not measured")
        return None
    times = [e.time_range.elapsed_us() for e in events
             if kernel in e.name and str(e.device_type).endswith("CUDA")]
    return statistics.median(times) / 1e3 if times else None


def timed(name, kernel, fn, plain, shape, nbytes, ops_ms, setup=None, **extra) -> dict:
    """One kernels-line timing entry: the kernel's device time (``ms``,
    profiler), the time of one wrapper call by CUDA events (``call_ms``,
    host launch overhead included), the plain version's call time and the
    bound: the larger of the bytes this input needs over the memory rate
    (``bytes_ms``) and the operations it needs over the integer rates
    (``ops_ms``)."""
    ms_dev = device_ms(fn, kernel, setup)
    call = cuda_ms(fn, setup)
    plain_ms = cuda_ms(plain, setup, reps=5)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    entry = dict(shape=shape, ms=ms_dev if ms_dev is not None else call,
                 ms_by="profiler" if ms_dev is not None else "events", call_ms=call,
                 plain_ms=plain_ms, bound_ms=max(t_bytes, ops_ms),
                 bound_by="bytes" if t_bytes >= ops_ms else "operations",
                 bytes=nbytes, bytes_ms=t_bytes, ops_ms=ops_ms, **extra)
    log(f"{name} {shape}: kernel {entry['ms']:.5f} ms ({entry['ms_by']}), call "
        f"{call:.5f} ms, plain {plain_ms:.5f} ms, bound {entry['bound_ms']:.5f} ms "
        f"by {entry['bound_by']} ({nbytes} bytes: {t_bytes:.5f} ms; operations: "
        f"{ops_ms:.5f} ms){''.join(f', {k} {v}' for k, v in extra.items())}")
    return entry


def sass_loop(lib_path, function: str) -> dict[str, int]:
    """Opcode counts of the longest loop (a backward branch) of the compiled
    kernel whose mangled name contains ``function``, from ``cuobjdump -sass``."""
    import collections
    import re

    from repro_torch.kernels import _build

    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    bodies = [body for name, body in zip(parts[1::2], parts[2::2]) if function in name]
    check(len(bodies) == 1, f"{len(bodies)} compiled functions match {function}")
    ins = [(int(addr, 16), op, rest) for addr, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)\S*\s*([^;]*);", bodies[0])]
    loops = [(int(m.group(1), 16), addr) for addr, op, rest in ins if op == "BRA"
             for m in [re.match(r"\W*0x([0-9a-f]+)", rest)] if m and int(m.group(1), 16) < addr]
    check(bool(loops), f"no loop found in the SASS of {function}")
    start, end = max(loops, key=lambda t: t[1] - t[0])
    return dict(collections.Counter(op for addr, op, _ in ins if start <= addr <= end))


def loop_ops_ms(n_iters: int, opcodes: dict[str, int], rates: dict) -> float:
    """Least time for ``n_iters`` trips of a loop with these opcode counts:
    the busiest of the ALU pipe, the IMAD pipe and instruction issue."""
    alu = sum(c for op, c in opcodes.items() if op in ALU_OPCODES)
    imad = sum(c for op, c in opcodes.items() if op.startswith("IMAD"))
    per_sm_clock = max(alu / ALU_LANES, imad / IMAD_LANES, sum(opcodes.values()) / ISSUE_LANES)
    return n_iters * per_sm_clock / (rates["sms"] * rates["clock_hz"]) * 1e3


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over integer outputs (as unsigned words)."""
    import torch

    err = 0
    for a, b in pairs:
        a = a.to(torch.int64) & 0xFFFFFFFF if a.dtype == torch.int32 else a.to(torch.int64)
        b = b.to(torch.int64) & 0xFFFFFFFF if b.dtype == torch.int32 else b.to(torch.int64)
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a - b).abs().max()))
    return err


# ----------------------------------------------------------------- phases


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    clock_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    rates = dict(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                 clock_hz=float(clock_mhz) * 1e6)
    log(f"card: {smi}; {rates['sms']} SMs, highest SM clock {clock_mhz} MHz")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, nvcc: {nvcc}, triton {triton_v}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi, rates


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_all()
    log(f"built {list(_build.KERNELS)} in {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc per source: {_build.build_seconds})")
    for name in _build.KERNELS:
        used = [l.split(":", 1)[1].strip() for l in _build.ptxas_log(name).splitlines()
                if "Used" in l]
        log(f"  ptxas {name}: {used[0] if used else 'cached build'}")


def make_testbeds():
    from repro_torch.rml import generator, serializer

    shutil.rmtree(WORK, ignore_errors=True)
    beds = {}
    for n_rows in (ROWS_SMALL, ROWS_PAPER):
        for kind in ("SOM", "OJM"):
            t0 = time.perf_counter()
            tb = generator.make_testbed(kind, n_rows, DUP, n_poms=N_POMS, seed=0)
            d = os.path.join(WORK, tb.name)
            tb.write(d)
            serializer.write_turtle(tb.doc, os.path.join(d, "map.ttl"))
            beds[(kind, n_rows)] = (tb, d, time.perf_counter() - t0)
            log(f"testbed {tb.name}: made and written as CSV in "
                f"{beds[(kind, n_rows)][2]:.2f} s")
    return beds


def ojm_shape(tb):
    """(|N_p|, largest span) of the OJM testbed's join, by numpy."""
    import numpy as np

    pk, pc = np.unique(tb.parent["ACCESSION_NUMBER"].astype(str), return_counts=True)
    ck = tb.child["ACCESSION_NUMBER"].astype(str)
    pos = np.searchsorted(pk, ck)
    hit = (pos < len(pk)) & (pk[np.minimum(pos, len(pk) - 1)] == ck)
    span = np.where(hit, pc[np.minimum(pos, len(pk) - 1)], 0)
    return int(span.sum()), int(span.max())


def phase_kernels(beds, rates):
    """K1 and K2 against their plain versions on the card, at main-path
    shapes; returns the kernels-line entries (launches filled in later)."""
    import numpy as np
    import torch

    from repro_torch.core import ptt
    from repro_torch.core.hashset import next_pow2
    from repro_torch.kernels import _build, bucket_dedup, hash_mix, ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    batch = 1 << 16
    som_cap = next_pow2(int(ROWS_PAPER / 0.6) + 16)
    tot, K = ojm_shape(beds[("OJM", ROWS_PAPER)][0])
    ojm_cap = next_pow2(int(tot / 0.6) + 16)
    log(f"main-path shapes: SOM batch {batch}, PTT {som_cap} slots in "
        f"{ptt.n_parts_for(som_cap)} parts; OJM |N_p|={tot}, K={K}, batch "
        f"{batch}x{K}={batch * K} lanes, PTT {ojm_cap} slots in "
        f"{ptt.n_parts_for(ojm_cap)} parts")

    # ---- K1 hash_mix: W=5 words (the triple key)
    k1_err, k1_ok = 0, True
    for n in (1, 4097, batch, batch * K):
        w = rng.integers(-2**31, 2**31, size=(5, n), dtype=np.int64).astype(np.int32)
        w[:, : min(n, 3)] = np.array([-1, 0x7FFFFFFF, 0], np.int32)[: min(n, 3)]
        words = torch.from_numpy(w).to(dev)
        for salt in (0, 2**32 + 3):
            got = hash_mix.hash_mix(words, salt)
            want = hash_mix.hash_mix_plain(words, salt)
            torch.cuda.synchronize()
            e = max_abs_err(zip(got, want))
            k1_err = max(k1_err, e)
            k1_ok &= e == 0
            log(f"K1 hash_mix n={n} salt={salt}: max_abs_err {e}")
    check(k1_ok, "hash_mix disagrees with its plain version on the card")
    # the operations K1 does per element: its compiled grid-stride loop at W=5
    k1_loop = sass_loop(_build._target("hash_mix"), "hash_mix_kernelILi5E")
    log(f"K1 compiled loop, one trip per element: {sum(k1_loop.values())} instructions "
        f"{k1_loop}")
    k1_entries = []
    for n in (batch, batch * K):
        words = torch.from_numpy(
            rng.integers(0, 2**31, size=(5, n)).astype(np.int32)).to(dev)
        k1_entries.append(timed(
            "K1", "hash_mix_kernel", lambda _: hash_mix.hash_mix(words),
            lambda _: hash_mix.hash_mix_plain(words), f"W=5,n={n}",
            nbytes=n * (4 * 5 + 8), ops_ms=loop_ops_ms(n, k1_loop, rates)))

    # ---- K2 bucket_dedup, through the radix insert the engine runs
    def keys(n, n_distinct, vfrac):
        vals = torch.from_numpy(rng.integers(0, n_distinct, size=n).astype(np.int32))
        hi, lo = hash_mix.hash_mix_plain(vals[None].to(dev))
        valid = torch.from_numpy(rng.random(n) < vfrac).to(dev)
        return hi, lo, valid

    def prefilled(cap, n_parts, n_distinct):
        t = ops.make_radix_table(cap, n_parts, device=dev)
        hi, lo, _ = keys(batch, n_distinct, 1.0)
        t, _, _ = ops.radix_dedup_insert(t, hi, lo, torch.ones_like(hi, dtype=torch.bool))
        return t

    # (name, table, (hi, lo, valid)): 75% duplicates within the batch
    # (n_distinct = n/4) and 5% invalid lanes at the 1M SOM shape, on an
    # empty and a prefilled table; the OJM shape, where most lanes are
    # padding; and a table far too small, which must overflow
    som_parts, ojm_parts = ptt.n_parts_for(som_cap), ptt.n_parts_for(ojm_cap)
    cases = [
        ("som_empty", ops.make_radix_table(som_cap, som_parts, device=dev),
         keys(batch, batch // 4, 0.95)),
        ("som_prefilled", prefilled(som_cap, som_parts, batch // 4),
         keys(batch, batch // 4, 0.95)),
        ("ojm_prefilled", prefilled(ojm_cap, ojm_parts, batch * K // 4),
         keys(batch * K, batch * K // 4, 0.3)),
        ("overflow", ops.make_radix_table(64, 1, device=dev), keys(4096, 10**6, 1.0)),
    ]
    k2_err, k2_entries = 0, []
    for name, table, (hi, lo, valid) in cases:
        b = ops.bin_lanes(hi, lo, valid, table.n_parts)
        stats = {}
        got = bucket_dedup.bucket_dedup(b.khi, b.klo, b.kval, table.hi.clone(), table.lo.clone())
        want = bucket_dedup.bucket_dedup_plain(
            b.khi, b.klo, b.kval, table.hi.clone(), table.lo.clone(), stats)
        torch.cuda.synchronize()
        e = max_abs_err(zip(got, want))
        # the whole radix insert on the card against it on the CPU
        t_gpu, new_gpu, ovf_gpu = ops.radix_dedup_insert(
            ops.RadixTable(table.hi.clone(), table.lo.clone()), hi, lo, valid)
        t_cpu, new_cpu, ovf_cpu = ops.radix_dedup_insert(
            ops.RadixTable(table.hi.cpu(), table.lo.cpu()), hi.cpu(), lo.cpu(), valid.cpu())
        e = max(e, max_abs_err([(t_gpu.hi.cpu(), t_cpu.hi), (t_gpu.lo.cpu(), t_cpu.lo),
                                (new_gpu.cpu(), new_cpu), (ovf_gpu.cpu(), ovf_cpu)]))
        k2_err = max(k2_err, e)
        log(f"K2 bucket_dedup {name}: parts={table.n_parts} part_len={b.khi.shape[1]} "
            f"cap={table.hi.shape[1]} new={int(got[2].sum())} overflow="
            f"{bool(got[3].any()) or bool(b.bin_ovf)} rounds={stats['rounds']} "
            f"probes={stats['probes']}: max_abs_err {e}")
        check(e == 0, f"bucket_dedup disagrees with its plain version ({name})")
        if name == "overflow":
            check(bool(ovf_gpu) and bool(ovf_cpu), "the forced overflow was not reported")
            continue
        if name == "som_empty":
            continue

        def fresh(table=table):
            return table.hi.clone(), table.lo.clone()

        # the least traffic: every lane's valid flag and verdict, the keys of
        # the lanes that hold one, and the distinct 32-byte sectors of the
        # hi and lo arrays that probes read and new keys are written to; the
        # design's own traffic stages every slot of every slice in and out
        lanes, slots = b.khi.numel(), table.hi.numel()
        sectors = stats["read_sectors"] + stats["write_sectors"]
        design = lanes * (4 + 4 + 1 + 1) + slots * 16 + table.n_parts
        k2_entries.append(timed(
            "K2", "bucket_dedup_kernel",
            lambda t: bucket_dedup.bucket_dedup(b.khi, b.klo, b.kval, *t),
            lambda t: bucket_dedup.bucket_dedup_plain(b.khi, b.klo, b.kval, *t),
            f"{name}:{table.n_parts}x{b.khi.shape[1]} lanes,"
            f"{table.n_parts}x{table.hi.shape[1]} slots",
            nbytes=lanes * 2 + int(b.kval.sum()) * 8 + sectors * 2 * 32 + table.n_parts,
            ops_ms=stats["probes"] * OPS_PER_PROBE / (
                ALU_LANES * rates["sms"] * rates["clock_hz"]) * 1e3,
            setup=fresh, keys=int(b.kval.sum()), probes=stats["probes"],
            sectors=sectors, design_bytes=design,
            design_ms=design / HBM_BYTES_PER_S * 1e3))
    return {
        "hash_mix": dict(err=k1_err, timings=k1_entries),
        "bucket_dedup": dict(err=k2_err, timings=k2_entries),
    }


def _distinct_pairs(a, b) -> int:
    import numpy as np

    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    return len(np.unique(ia.astype(np.int64) * (int(ib.max()) + 1) + ib))


def expected_triples(tb, d) -> dict[str, int]:
    """Distinct (subject, object) value pairs per predicate, by numpy from
    the written CSV files."""
    import numpy as np

    def read(path):
        with open(path, encoding="utf-8") as f:
            header = f.readline().rstrip("\n").split(",")
        cells = np.loadtxt(path, dtype=str, delimiter=",", skiprows=1, comments=None)
        return {h: cells[:, i] for i, h in enumerate(header)}

    tables = {"child.csv": read(os.path.join(d, "child.csv"))}
    if tb.parent is not None:
        tables["parent.csv"] = read(os.path.join(d, "parent.csv"))
    child = tables["child.csv"]
    # class triples: one per distinct subject of every map with a class;
    # the maps' subject templates differ, so their subjects never coincide
    out = {"http://www.w3.org/1999/02/22-rdf-syntax-ns#type": sum(
        len(np.unique(tables[m.source.path][m.subject.columns[0]]))
        for m in tb.doc.triples_maps.values() if m.subject_class)}
    tm = tb.doc.triples_maps["TriplesMap1"]
    subj = child["MUTATION_ID"]
    if tb.parent is None:
        for pom in tm.poms:
            out[pom.predicate] = _distinct_pairs(subj, child[pom.object_map.reference])
        return out
    parent = tables["parent.csv"]
    keys, kid = np.unique(np.concatenate([child["ACCESSION_NUMBER"],
                                          parent["ACCESSION_NUMBER"]]), return_inverse=True)
    ck, pk = kid[: len(subj)], kid[len(subj):]
    order = np.argsort(pk, kind="stable")
    starts = np.searchsorted(pk[order], np.arange(len(keys) + 1))
    cnt = starts[ck + 1] - starts[ck]
    rows = np.repeat(np.arange(len(ck)), cnt)
    offs = np.arange(len(rows)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    prow = order[starts[ck[rows]] + offs]
    n = _distinct_pairs(subj[rows], parent["EXON_ID"][prow])
    for pom in tm.poms:  # one exon map per pom, all over the same join
        out[pom.predicate] = n
    return out


def phase_rdfize(beds, kernel_mods):
    from repro_torch.launch import rdfize

    def run(tb, d, device):
        out = os.path.join(d, f"kg-{device}.nt")
        t0 = time.perf_counter()
        result = rdfize.main(["--mapping", os.path.join(d, "map.ttl"), "--data-root", d,
                              "--out", out, "--device", device])
        total = time.perf_counter() - t0
        log(f"rdfize {tb.name} on {device}: {result.n_triples} triples in {total:.3f} s "
            f"end to end (CSV made and written before: {beds_time(tb)[2]:.2f} s; "
            f"load+encode {result.load_encode_s:.3f} s; engine rest "
            f"{result.wall_time_s - result.load_encode_s:.3f} s; parse+plan+N-Triples "
            f"{total - result.wall_time_s:.3f} s); {result.n_triples / total:.0f} triples/s "
            f"end to end, {result.n_triples / max(result.wall_time_s - result.load_encode_s, 1e-9):.0f}"
            " triples/s in the engine after encoding")
        return result, out

    def beds_time(tb):
        return next(v for v in beds.values() if v[0] is tb)

    order = [("SOM", ROWS_SMALL), ("OJM", ROWS_SMALL), ("SOM", ROWS_PAPER), ("OJM", ROWS_PAPER)]
    totals = {name: 0 for name in kernel_mods}
    outs = {}
    for key in order:
        tb, d, _ = beds[key]
        for mod in kernel_mods.values():  # counts to 0 just before the run
            mod.launches = 0
        result, path = run(tb, d, "cuda")
        counts = {name: mod.launches for name, mod in kernel_mods.items()}  # just after
        log(f"  launches during {tb.name}: {counts}")
        for name in totals:
            totals[name] += counts[name]
        outs[key] = (result, path)
    for name, n in totals.items():
        check(n > 0, f"{name} was never launched on the main path")

    for kind in ("SOM", "OJM"):  # the small tier on the CPU: same bytes
        tb, d, _ = beds[(kind, ROWS_SMALL)]
        _, cpu_path = run(tb, d, "cpu")
        with open(cpu_path, "rb") as f1, open(outs[(kind, ROWS_SMALL)][1], "rb") as f2:
            check(f1.read() == f2.read(), f"{tb.name}: cuda and cpu N-Triples differ")
        log(f"{tb.name}: cuda and cpu N-Triples are byte-identical")

    for kind in ("SOM", "OJM"):  # the paper's tier: no duplicate, exact counts
        tb, d, _ = beds[(kind, ROWS_PAPER)]
        result, path = outs[(kind, ROWS_PAPER)]
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        check(len(lines) == result.n_triples, f"{tb.name}: line count")
        check(len(set(lines)) == len(lines), f"{tb.name}: duplicate N-Triples lines")
        want = expected_triples(tb, d)
        got = {p: st.n_unique for p, st in result.stats.items()}
        check(got == want, f"{tb.name}: triples per predicate {got} != numpy {want}")
        log(f"{tb.name}: {len(lines)} distinct lines; per-predicate counts equal "
            f"numpy's distinct pairs from the CSV: {want}")

    # the paper's tier once more under torch.profiler (CUDA activity only):
    # how busy the card is over a whole rdfize run, and on what
    import torch
    from torch.profiler import ProfilerActivity, profile

    for kind in ("SOM", "OJM"):
        tb, d, _ = beds[(kind, ROWS_PAPER)]
        log(f"profiled rerun of {tb.name}:")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(tb, d, "cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = prof.events()
        except Exception as e:  # a measurement the card could not give
            log(f"  torch.profiler failed ({type(e).__name__}: {e})")
            events = []
        dev = [e for e in events if str(e.device_type).endswith("CUDA")]
        if not dev:
            log(f"  device busy share: not measured (the profiler recorded no device event)")
            continue
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
        per = {k: sum(e.time_range.elapsed_us() for e in dev if f"{k}_kernel" in e.name) / 1e6
               for k in kernel_mods}
        log(f"  device busy {busy:.4f} s of {wall:.3f} s wall ({100 * busy / wall:.3f}%, "
            f"idle {100 - 100 * busy / wall:.3f}%); {len(dev)} device events; "
            + ", ".join(f"{k} {v:.4f} s" for k, v in per.items())
            + f", other device work {busy - sum(per.values()):.4f} s")
    return totals


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs an NVIDIA card")
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        log(f"FAIL: no src/repro_torch beside {os.path.basename(__file__)}; run it "
            "from a checkout of the repository")
        return 1
    sys.path.insert(0, src)
    try:
        from repro_torch.kernels import bucket_dedup, hash_mix

        log("phase 1: device and toolchain")
        smi, rates = phase_device()
        log("phase 2: build the kernels")
        phase_build()
        log("phase 3: testbeds")
        beds = make_testbeds()
        log("phase 4: kernels against their plain versions on the card")
        kres = phase_kernels(beds, rates)
        log("phase 5: rdfize on the card (and the 100K tier on the CPU)")
        mods = {"hash_mix": hash_mix, "bucket_dedup": bucket_dedup}
        launches = phase_rdfize(beds, mods)
    except Exception as e:  # every phase's failure ends the run here
        traceback.print_exc()
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    meta = {
        "hash_mix": ("src/repro_torch/csrc/hash_mix.cu", "src/repro/kernels/hash_mix.py:29"),
        "bucket_dedup": ("src/repro_torch/csrc/bucket_dedup.cu",
                         "src/repro/kernels/bucket_dedup.py:43"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        t = kres[name]["timings"][-1]  # the largest main-path shape
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": kres[name]["err"],
            "matched": kres[name]["err"] == 0, **t, "library_ms": None,
            "other_shapes": kres[name]["timings"][:-1],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

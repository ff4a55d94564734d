#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. device and toolchain: the card's name and power limit, the torch,
     CUDA, nvcc and Triton versions;
  2. build the four CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     per source, started together) and time the build;
  3. make the paper's testbeds (SOM and OJM, two predicate-object maps,
     75% duplicates) at 100K and 1M rows, and an OJM one at 20K rows,
     written as CSV with RML mappings;
  4. hold each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it, with exact equality (every output is
     an integer); after a warm-up, time the kernel on the device with
     ``torch.profiler`` and one wrapper call and the plain version with CUDA
     events; bound each by the bytes its input needs and by the operations
     it needs (K1: its compiled loop, read with ``cuobjdump -sass``; K3: one
     compare a (child, parent) pair, on the pipe the compiled compare
     issues to); K3's compiled scan loop is read and counted a pair, and its
     1M launch is checked on its first and its last 65,536 child rows;
  5. drive ``rdfize`` through ``repro_torch.launch.rdfize.main``, each path
     with the kernels' launch counters set to 0 just before it and read just
     after: the optimized engine (sorted PJTT) on every testbed, then at 1M
     rows the naive engine (SOM, and OJM: the paper's "did not finish"
     cell), the hash PJTT (OJM) and the streamed engine (SOM, OJM).  The
     100K runs, and the naive OJM at 20K, are repeated on the CPU and their
     N-Triples must be byte-identical to the card's; every 1M output must
     hold no duplicate line, exactly the distinct triples a numpy count of
     the CSV gives, and the same sorted lines as the optimized eager run; a
     profiled rerun of the optimized 1M runs and of the naive OJM 1M run
     gives the card's busy share over the whole run;
  6. write ``.kgz`` stores with ``rdfize --emit kgz`` on the card at 100K and
     1M rows (SOM and OJM); at 100K the card's bytes must equal a
     ``--device cpu`` run's;
  7. hold K4 (``scan_join``, the serving fast path) against its plain
     version on the card, exactly, for the ``single`` and ``bgp3`` chains of
     ``serve/bench.py`` at batch 1, 8 and 64 over the 1M stores, at the
     capacities the executor converges to; time it like phase 4 and bound
     it by the 32-byte sectors its searches touch, the gathered columns and
     the outputs, and by its search compares and sort compare-exchanges;
     print its chain of dependent loads (the k-ary searches' and a
     bisection's);
  8. serve the six ``serve/bench.py`` query classes at batch 1, 8, 64 and
     4096: the card's rows must equal the CPU's over the 100K and the 1M
     stores, and over the 100K stores a query a class must equal
     ``oracle_select``'s; then ``serve.bench.bench_serve`` over the 1M
     stores on the card (K4's launch count set to 0 just before, and above
     0 just after, or the phase fails) prints queries/s and p50/p99
     dispatch latency per class and batch, and the card's busy share in a
     fast-path window and in general-path windows at batch 1 and 4096;
  9. print the kernels line (one JSON object, all four kernels), the card
     line, and last the result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.  Generated data
lives under ``build/chip_smoke/`` and is removed at the end.
"""

from __future__ import annotations

import hashlib
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
ROWS_NAIVE_CPU = 20_000  # the naive OJM on the CPU: 4e8 compares a map
K3_SLICE = 65_536  # child rows of the 1M shape checked against the plain join
CARD = "cuda"  # the device of the serving phases (6-8)


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def bare_ms(launch, n: int = 100) -> float:
    """Device time of one launch by CUDA events around ``n`` back-to-back
    bare launches (arguments built once, no other work between them), after
    a warm-up: the kernel's time wherever enqueueing a launch takes less
    than running it."""
    import torch

    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def timed(name, kernel, fn, plain, shape, nbytes, ops_ms, setup=None, reps=20,
          plain_reps=5, plain_warmup=3, bare=None, **extra) -> dict:
    """One kernels-line timing entry: the kernel's device time (``ms``,
    profiler; where the profiler records no such kernel, CUDA events around
    back-to-back ``bare`` launches, else around wrapper calls), the time of
    one wrapper call by CUDA events (``call_ms``, host launch overhead
    included), the plain version's call time and the bound: the larger of
    the bytes this input needs over the memory rate (``bytes_ms``) and the
    operations it needs over the integer rates (``ops_ms``)."""
    ms_dev = device_ms(fn, kernel, setup, reps=reps)
    call = cuda_ms(fn, setup, reps=reps)
    if bare is not None:
        extra["bare_ms"] = bare_ms(bare)
    plain_ms = cuda_ms(plain, setup, reps=plain_reps, warmup=plain_warmup)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if ms_dev is not None:
        ms, ms_by = ms_dev, "profiler"
    elif bare is not None:
        ms, ms_by = extra["bare_ms"], "events, back-to-back bare launches"
    else:
        ms, ms_by = call, "events"
    entry = dict(shape=shape, ms=ms, ms_by=ms_by, call_ms=call,
                 plain_ms=plain_ms, bound_ms=max(t_bytes, ops_ms),
                 bound_by="bytes" if t_bytes >= ops_ms else "operations",
                 bytes=nbytes, bytes_ms=t_bytes, ops_ms=ops_ms, **extra)
    log(f"{name} {shape}: kernel {entry['ms']:.5f} ms ({entry['ms_by']}), call "
        f"{call:.5f} ms, plain {plain_ms:.5f} ms, bound {entry['bound_ms']:.5f} ms "
        f"by {entry['bound_by']} ({nbytes} bytes: {t_bytes:.5f} ms; operations: "
        f"{ops_ms:.5f} ms){''.join(f', {k} {v}' for k, v in extra.items())}")
    return entry


def _sass_function(lib_path, function: str):
    """(address, opcode, opcode with its modifiers, operands) of each
    instruction of the compiled kernel whose mangled name contains
    ``function``, from ``cuobjdump -sass``."""
    import re

    from repro_torch.kernels import _build

    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    bodies = [body for name, body in zip(parts[1::2], parts[2::2]) if function in name]
    check(len(bodies) == 1, f"{len(bodies)} compiled functions match {function}")
    return [(int(addr, 16), op, op + mods, rest) for addr, op, mods, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*);",
        bodies[0])]


def sass_loop(lib_path, function: str) -> dict[str, int]:
    """Opcode counts of the longest loop (a backward branch) of the compiled
    kernel whose mangled name contains ``function``."""
    import collections
    import re

    ins = _sass_function(lib_path, function)
    loops = [(int(m.group(1), 16), addr) for addr, op, _, rest in ins if op == "BRA"
             for m in [re.match(r"\W*0x([0-9a-f]+)", rest)] if m and int(m.group(1), 16) < addr]
    check(bool(loops), f"no loop found in the SASS of {function}")
    start, end = max(loops, key=lambda t: t[1] - t[0])
    return dict(collections.Counter(op for addr, op, _, _ in ins if start <= addr <= end))


def sass_groups(lib_path, function: str, min_compares: int) -> list[dict[str, int]]:
    """K3's compiled scan groups: each straight run of instructions from a
    16-byte shared load (``LDS.128``) to the next branch that holds at
    least ``min_compares`` ISETPs (the slow path's subject loads hold
    fewer), as opcode counts with their modifiers."""
    import collections

    ins = _sass_function(lib_path, function)
    groups = []
    for i, (_, _, full, _) in enumerate(ins):
        if full != "LDS.128":
            continue
        end = next((k for k in range(i + 1, len(ins)) if ins[k][1] == "BRA"), len(ins) - 1)
        seg = collections.Counter(f for _, _, f, _ in ins[i: end + 1])
        if sum(c for f, c in seg.items() if f.startswith("ISETP")) >= min_compares:
            groups.append(dict(seg))
    return groups


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
    for kind, n_rows in [(k, n) for n in (ROWS_SMALL, ROWS_PAPER) for k in ("SOM", "OJM")] + [
            ("OJM", ROWS_NAIVE_CPU)]:
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


def join_inputs(tb, dev):
    """The OJM testbed's join as K3 takes it: parent keys and subjects and
    child keys, dictionary ids (int32) on the card."""
    import numpy as np
    import torch

    child, parent = tb.child["ACCESSION_NUMBER"], tb.parent["ACCESSION_NUMBER"]
    _, kid = np.unique(np.concatenate([child, parent]).astype(str), return_inverse=True)
    _, sid = np.unique(tb.parent["EXON_ID"].astype(str), return_inverse=True)
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in (kid[len(child):], sid, kid[: len(child)]))


def phase_kernels(beds, rates):
    """K1, K2 and K3 against their plain versions on the card, at main-path
    shapes; returns the kernels-line entries (launches filled in later)."""
    import numpy as np
    import torch

    from repro_torch.core import ptt
    from repro_torch.core.hashset import next_pow2
    from repro_torch.kernels import _build, bucket_dedup, hash_mix, nested_join, ops

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
    # ---- K3 nested_join: the naive OJM's join, on the testbeds' own keys
    # the compiled scan groups of the variant the 1M shape launches: 4
    # parents against R keys, from the 16-byte key load to the branch
    k3_R = nested_join.pick_rows_per_thread(ROWS_PAPER, rates["sms"])
    groups = sass_groups(_build._target("nested_join"), f"nested_join_kernelILi{k3_R}E",
                         4 * k3_R)
    check(bool(groups), "no compiled scan group of 4 x R ISETP compares in nested_join")
    g_pairs = 4 * k3_R * len(groups)
    g_all = sum(sum(g.values()) for g in groups)
    g_isetp = sum(c for g in groups for op, c in g.items() if op.startswith("ISETP"))
    g_alu = sum(c for g in groups for op, c in g.items() if op.split(".")[0] in ALU_OPCODES)
    k3_sass = dict(rows_per_thread=k3_R, groups=len(groups), instructions_per_pair=g_all / g_pairs,
                   isetp_per_pair=g_isetp / g_pairs, alu_per_pair=g_alu / g_pairs)
    log(f"K3 compiled scan (R={k3_R}): {len(groups)} copies of the group of {4 * k3_R} "
        f"(child, parent) pairs, {k3_sass['instructions_per_pair']:.4f} instructions a pair, "
        f"ISETP {k3_sass['isetp_per_pair']:.4f} a pair, ALU pipe "
        f"{k3_sass['alu_per_pair']:.4f} a pair; the groups' opcodes: {groups}")
    k3_err, k3_entries = 0, []

    def k3_case(name, pk, ps, ck, K):
        nonlocal k3_err
        got = nested_join.nested_join(pk, ps, ck, K)
        want = nested_join.nested_join_plain(pk, ps, ck, K)
        torch.cuda.synchronize()
        e = max_abs_err(zip(got, want))
        k3_err = max(k3_err, e)
        log(f"K3 nested_join {name}: m={ck.numel()} n={pk.numel()} K={K} matches="
            f"{int(got[1].sum())} truncated={bool(got[2])}: max_abs_err {e}")
        check(e == 0, f"nested_join disagrees with its plain version ({name})")

    def k3_timed(pk, ps, ck, K, **kw):
        m, n = ck.numel(), pk.numel()
        return timed(
            "K3", "nested_join_kernel", lambda _: nested_join.nested_join(pk, ps, ck, K),
            lambda _: nested_join.nested_join_plain(pk, ps, ck, K), f"m={m},n={n},K={K}",
            nbytes=4 * m + 8 * n + 5 * m * K,
            ops_ms=m * n / (ALU_LANES * rates["sms"] * rates["clock_hz"]) * 1e3,
            compares=m * n, **kw)

    small = join_inputs(beds[("OJM", ROWS_SMALL)][0], dev)
    _, K_small = ojm_shape(beds[("OJM", ROWS_SMALL)][0])
    k3_case("100K OJM", *small, K_small)
    k3_case("100K OJM, K=1 (truncated)", *small, 1)
    paper = join_inputs(beds[("OJM", ROWS_PAPER)][0], dev)
    pk, ps, ck = paper
    k3_case(f"1M OJM, child rows 0..{K3_SLICE}", pk, ps, ck[:K3_SLICE].contiguous(), K)
    # one launch over all 1M child rows: its first and its last rows (the
    # ragged last CTA) against the plain join of those rows
    m = ck.numel()
    full = nested_join.nested_join(pk, ps, ck, K)
    for rows in (slice(0, K3_SLICE), slice(m - K3_SLICE, m)):
        want = nested_join.nested_join_plain(pk, ps, ck[rows].contiguous(), K)
        torch.cuda.synchronize()
        e = max_abs_err([(full[0][rows], want[0]), (full[1][rows], want[1])])
        k3_err = max(k3_err, e)
        log(f"K3 nested_join 1M OJM, one launch, child rows {rows.start}..{rows.stop}: "
            f"matches={int(full[1][rows].sum())}: max_abs_err {e}")
        check(e == 0, f"nested_join disagrees with its plain version (rows {rows})")
    del full
    k3_entries.append(k3_timed(*small, K_small, plain_reps=3))
    k3_entries.append(k3_timed(pk, ps, ck, K, reps=5, plain_reps=1, plain_warmup=0,
                               **k3_sass))
    return {
        "hash_mix": dict(err=k1_err, timings=k1_entries),
        "bucket_dedup": dict(err=k2_err, timings=k2_entries),
        "nested_join": dict(err=k3_err, timings=k3_entries),
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


# (label, rdfize flags, the kernels that path must launch)
PATHS = {
    "optimized": ([], ("hash_mix", "bucket_dedup")),
    "naive": (["--engine", "naive"], ("hash_mix",)),
    "hash": (["--join", "hash"], ("hash_mix", "bucket_dedup")),
    "stream": (["--stream"], ("hash_mix", "bucket_dedup")),
}
NAIVE_OJM_KERNELS = ("hash_mix", "nested_join")


def sorted_digest(lines) -> str:
    return hashlib.sha256("\n".join(sorted(lines)).encode()).hexdigest()


def phase_rdfize(beds, kernel_mods):
    from repro_torch.launch import rdfize

    def run(kind, n_rows, path, device):
        tb, d, made_s = beds[(kind, n_rows)]
        out = os.path.join(d, f"kg-{path}-{device}.nt")
        t0 = time.perf_counter()
        result = rdfize.main(["--mapping", os.path.join(d, "map.ttl"), "--data-root", d,
                              "--out", out, "--device", device, *PATHS[path][0]])
        total = time.perf_counter() - t0
        log(f"rdfize {tb.name} {path} on {device}: {result.n_triples} triples in "
            f"{total:.3f} s end to end (CSV made and written before: {made_s:.2f} s; "
            f"load+encode {result.load_encode_s:.3f} s; engine rest "
            f"{result.wall_time_s - result.load_encode_s:.3f} s; parse+plan+N-Triples "
            f"{total - result.wall_time_s:.3f} s); {result.n_triples / total:.0f} triples/s "
            f"end to end, {result.n_triples / max(result.wall_time_s - result.load_encode_s, 1e-9):.0f}"
            " triples/s in the engine after encoding")
        return result, out

    def run_on_card(kind, n_rows, path):
        for mod in kernel_mods.values():  # counts to 0 just before the run
            mod.launches = 0
        result, out = run(kind, n_rows, path, "cuda")
        counts = {name: mod.launches for name, mod in kernel_mods.items()}  # just after
        log(f"  launches during {path} {kind} {n_rows}: {counts}")
        need = NAIVE_OJM_KERNELS if (path, kind) == ("naive", "OJM") else PATHS[path][1]
        for name in need:
            check(counts[name] > 0, f"{name} was never launched on the {path} {kind} path")
        for name in totals:
            totals[name] += counts[name]
        return result, out

    def read_lines(path):
        with open(path, encoding="utf-8") as f:
            return f.read().splitlines()

    def same_bytes_as_cpu(kind, n_rows, path, cuda_out):
        _, cpu_out = run(kind, n_rows, path, "cpu")
        with open(cpu_out, "rb") as f1, open(cuda_out, "rb") as f2:
            check(f1.read() == f2.read(), f"{path} {kind} {n_rows}: cuda and cpu N-Triples differ")
        log(f"{path} {kind} {n_rows}: cuda and cpu N-Triples are byte-identical")
        os.remove(cpu_out)

    totals = {name: 0 for name in kernel_mods}
    digests = {}
    for n_rows in (ROWS_SMALL, ROWS_PAPER):  # the optimized eager engine
        for kind in ("SOM", "OJM"):
            result, out = run_on_card(kind, n_rows, "optimized")
            if n_rows == ROWS_SMALL:
                same_bytes_as_cpu(kind, n_rows, "optimized", out)
            else:
                check_paper_tier(beds, kind, "optimized", result, out, digests)
            os.remove(out)

    # the paths of slice 2 at the paper's tier, each against the optimized
    # eager run's sorted lines; then on the small tier, cuda against cpu
    for path, kinds in (("naive", ("SOM", "OJM")), ("hash", ("OJM",)),
                        ("stream", ("SOM", "OJM"))):
        for kind in kinds:
            result, out = run_on_card(kind, ROWS_PAPER, path)
            check_paper_tier(beds, kind, path, result, out, digests)
            os.remove(out)
    for path, kind, n_rows in (("naive", "SOM", ROWS_SMALL), ("naive", "OJM", ROWS_NAIVE_CPU),
                               ("hash", "OJM", ROWS_SMALL), ("stream", "SOM", ROWS_SMALL),
                               ("stream", "OJM", ROWS_SMALL)):
        _, out = run_on_card(kind, n_rows, path)
        same_bytes_as_cpu(kind, n_rows, path, out)
        os.remove(out)

    # the paper's tier once more under torch.profiler (CUDA activity only):
    # how busy the card is over a whole rdfize run, and on what
    import torch
    from torch.profiler import ProfilerActivity, profile

    for kind, path in (("SOM", "optimized"), ("OJM", "optimized"), ("OJM", "naive")):
        tb, d, _ = beds[(kind, ROWS_PAPER)]
        log(f"profiled rerun of {tb.name} {path}:")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, out = run(kind, ROWS_PAPER, path, "cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = prof.events()
            os.remove(out)
        except Exception as e:  # a measurement the card could not give
            log(f"  torch.profiler failed ({type(e).__name__}: {e})")
            events = []
        dev = [e for e in events if str(e.device_type).endswith("CUDA")]
        if not dev:
            log("  device busy share: not measured (the profiler recorded no device event)")
            continue
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
        per = {k: sum(e.time_range.elapsed_us() for e in dev if f"{k}_kernel" in e.name) / 1e6
               for k in kernel_mods}
        log(f"  device busy {busy:.4f} s of {wall:.3f} s wall ({100 * busy / wall:.3f}%, "
            f"idle {100 - 100 * busy / wall:.3f}%); {len(dev)} device events; "
            + ", ".join(f"{k} {v:.4f} s" for k, v in per.items())
            + f", other device work {busy - sum(per.values()):.4f} s")
    return totals


def check_paper_tier(beds, kind, path, result, out, digests) -> None:
    """A 1M output: no duplicate line, per-predicate counts equal to numpy's
    distinct pairs, and the optimized eager run's sorted lines."""
    tb, d, _ = beds[(kind, ROWS_PAPER)]
    with open(out, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(len(lines) == result.n_triples, f"{tb.name} {path}: line count")
    check(len(set(lines)) == len(lines), f"{tb.name} {path}: duplicate N-Triples lines")
    want = expected_triples(tb, d)
    got = {p: st.n_unique for p, st in result.stats.items()}
    check(got == want, f"{tb.name} {path}: triples per predicate {got} != numpy {want}")
    digest = sorted_digest(lines)
    ref = digests.setdefault(kind, digest)  # the optimized run comes first
    check(digest == ref, f"{tb.name} {path}: sorted lines differ from the optimized run's")
    log(f"{tb.name} {path}: {len(lines)} distinct lines; per-predicate counts equal "
        f"numpy's distinct pairs from the CSV: {want}; sorted-lines sha256 {digest[:16]} "
        "equals the optimized eager run's")


# ------------------------------------------------------------------ serving

SERVE_BATCHES = (1, 8, 64, 4096)
K4_BATCHES = (1, 8, 64)
K4_CLASSES = ("single", "bgp3")  # the chain classes the fast path takes
OPS_PER_ROUND = 8  # K4: midpoint, clamp, two compares, the select of lo/hi
OPS_PER_CX_COLUMN = 3  # K4's sort: compare, and a swap's two selects, a column


def phase_kgz(beds, kernel_mods):
    """``rdfize --emit kgz`` on the card at both tiers; at 100K the CPU's
    bytes must equal the card's.  Returns the .kgz paths and the launches."""
    from repro_torch.launch import rdfize

    paths, totals = {}, {name: 0 for name in kernel_mods}
    for n_rows in (ROWS_SMALL, ROWS_PAPER):
        for kind in ("SOM", "OJM"):
            tb, d, _ = beds[(kind, n_rows)]
            out = {}
            for device in (CARD, "cpu") if n_rows == ROWS_SMALL else (CARD,):
                out[device] = os.path.join(d, f"kg-{device}-{len(out)}.kgz")
                for mod in kernel_mods.values():
                    mod.launches = 0
                t0 = time.perf_counter()
                rdfize.main(["--mapping", os.path.join(d, "map.ttl"), "--data-root", d,
                             "--out", out[device], "--device", device, "--emit", "kgz"])
                wall = time.perf_counter() - t0
                with open(out[device], "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                counts = {name: mod.launches for name, mod in kernel_mods.items()}
                log(f"rdfize --emit kgz {tb.name} on {device}: {wall:.3f} s end to end, "
                    f"{os.path.getsize(out[device])} bytes, sha256 {digest[:16]}; "
                    f"launches {counts}")
                if device == CARD:
                    for name in ("hash_mix", "bucket_dedup"):
                        check(counts[name] > 0, f"{name} was never launched on --emit kgz")
                    for name in totals:
                        totals[name] += counts[name]
            if n_rows == ROWS_SMALL:
                with open(out[CARD], "rb") as f1, open(out["cpu"], "rb") as f2:
                    check(f1.read() == f2.read(), f"{tb.name}: cuda and cpu .kgz differ")
                log(f"{tb.name}: cuda and cpu .kgz are byte-identical")
            paths[(kind, n_rows)] = out[CARD]
    return paths, totals


def open_stores(paths):
    """Every .kgz on the card and on the CPU, through the open-store cache."""
    from repro_torch.kg import persist

    stores = {}
    for (kind, n_rows), path in paths.items():
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            st = persist.open_store(path, device=CARD if device == "cuda" else "cpu")
            stores[(kind, n_rows, device)] = st
            log(f"opened {kind} {n_rows} on {device}: {st.n_triples} triples, "
                f"{st.n_terms} terms, packed keys "
                f"{st.device_keys('spo') is not None}, {time.perf_counter() - t0:.2f} s")
    return stores


def k4_work(spec, caps, operands, qbuf):
    """What K4's function needs for this input, by replaying the plain
    chain with its searches recorded: the distinct 32-byte sectors of
    khi/klo (and prim_start) the search rounds read, the rounds run, the
    gathered rows, and the sort's compare-exchanges (valid queries only).
    A search is counted where its primary term is bound (>= 0); a wildcard
    primary searches the whole index."""
    import numpy as np
    import torch

    from repro_torch.kernels import scan_join as K

    probes = {}  # id(khi) -> list of probed rows
    prim_reads = {}
    rounds = [0]
    orig = K._reader_range

    def recording(spec_, r, khi, klo, prim, lo_q, hi_q, primary_q):
        res = orig(spec_, r, khi, klo, prim, lo_q, hi_q, primary_q)
        for side, upper in ((lo_q, False), (hi_q, True)):
            qhi, qlo = K.pack_bound(*side, spec_.key_bits)
            if primary_q is None:
                keep = torch.ones(qhi.shape, dtype=torch.bool, device=qhi.device)
                lo = torch.zeros_like(qhi)
                hi = torch.full_like(qhi, khi.shape[0])
                n_rounds = spec_.rounds
            else:
                keep = primary_q >= 0
                g0 = primary_q.clamp(0, max(prim.shape[0] - 2, 0))
                lo, hi = prim[g0], prim[g0 + 1]
                prim_reads.setdefault(id(prim), []).append(g0[keep].reshape(-1))
                n_rounds = r.prim_rounds
            lo, hi, qhi, qlo = (t[keep].reshape(-1) for t in (lo, hi, qhi, qlo))
            for _ in range(n_rounds):
                open_ = lo < hi
                mid = lo + ((hi - lo) >> 1)
                g = mid.clamp(0, max(khi.shape[0] - 1, 0))
                probes.setdefault(id(khi), []).append(g[open_])
                rounds[0] += int(open_.sum())
                mhi, mlo = khi[g], klo[g]
                tail = (mlo <= qlo) if upper else (mlo < qlo)
                before = (mhi < qhi) | ((mhi == qhi) & tail)
                lo, hi = (torch.where(open_ & before, mid + 1, lo),
                          torch.where(open_ & ~before, mid, hi))
        return res

    R = len(spec.readers)
    K._reader_range = recording
    try:
        outs, n, needed = K.chain_plain(
            spec, caps, [tuple(operands[6 * i: 6 * i + 6]) for i in range(R)],
            *K._unpack_qrows(spec, qbuf))
    finally:
        K._reader_range = orig
    sectors = sum(len(torch.unique(torch.cat(v) // 8)) for v in probes.values())
    sectors_prim = 0
    for v in prim_reads.values():
        g0 = torch.cat(v)
        sectors_prim += len(torch.unique(torch.cat([g0, g0 + 1]) // 8))
    valid_q = int((qbuf[:, 3 * R] != 0).sum())
    cap = caps[-1]
    L = int(np.log2(cap))
    cx = valid_q * (cap // 2) * L * (L + 1) // 2 if spec.out_cols else 0
    # gathered store columns: each stage's valid rows times the columns it binds
    gathered = sum(int(needed[:, k].clamp(min=0, max=caps[k]).sum()) * len(r.out)
                   for k, r in enumerate(spec.readers))
    out_bytes = 4 * (len(outs) * qbuf.shape[0] * cap + qbuf.shape[0] * (1 + R))
    nbytes = (qbuf.numel() * 4 + 2 * 32 * sectors + 32 * sectors_prim + 4 * gathered
              + out_bytes)
    return dict(sectors=sectors, prim_sectors=sectors_prim, rounds=rounds[0],
                gathered=gathered, cx=cx, nbytes=nbytes,
                ops=rounds[0] * OPS_PER_ROUND + cx * OPS_PER_CX_COLUMN * len(spec.out_cols))


def phase_k4(stores, rates):
    """K4 against its plain version on the card over the 1M stores: the
    ``single`` and ``bgp3`` chains at batch 1, 8 and 64, at the capacities
    the executor converges to.  Returns the kernels-line entry data."""
    import torch

    from repro_torch.kernels import scan_join as K
    from repro_torch.serve import bench
    from repro_torch.serve.exec import get_executor

    err, entries = 0, []
    for kind in ("SOM", "OJM"):
        store = stores[(kind, ROWS_PAPER, "cuda")]
        ex = get_executor(store)
        p0, classes = bench._classes(store)
        for name in K4_CLASSES:
            qtext = dict(classes)[name]
            for batch in K4_BATCHES:
                plan, batches, fops = bench._encoded_batches(ex, qtext, p0, batch, 4, seed=1)
                for consts in batches:  # converge the capacity floors
                    ex.execute_encoded(plan, consts, fops)
                fp = ex._fastpaths.get(plan.sig)
                check(fp is not None, f"{kind} {name}: the plan is not a fast-path chain")
                caps = tuple(fp.caps())
                qbuf = fp.stage(batches[-1], None, batch).to(CARD)
                got = K.scan_join(fp.spec, caps, *fp.operands, qbuf)
                want = K.scan_join_plain(fp.spec, caps, *fp.operands, qbuf)
                if CARD == "cuda":
                    torch.cuda.synchronize()
                e = max_abs_err([(got[1], want[1]), (got[2], want[2]), *zip(got[0], want[0])])
                err = max(err, e)
                R = len(fp.spec.readers)
                # stage 0's chain of dependent loads, as the kernel counts it
                # (the primary term's range when seeded, then one a round)
                loads = torch.zeros((qbuf.shape[0], 2), dtype=torch.int32, device=CARD)
                K.prepare_launch(fp.spec, caps, *fp.operands, qbuf, stage0_loads=loads)[0]()
                stage0 = int(loads.max())
                r0 = fp.spec.readers[0]
                seeded = r0.src[0][0] != "w"
                bisection = seeded + (r0.prim_rounds if seeded else fp.spec.rounds)
                log(f"K4 scan_join {kind} 1M {name} batch {batch}: readers {R}, caps {caps}, "
                    f"rows {int(got[1][:batch].sum())}, needed {got[2].tolist()}, stage-0 "
                    f"dependent loads {stage0} (counted by the kernel; a bisection of the "
                    f"spec's fixed rounds would make {bisection}): max_abs_err {e}")
                check(e == 0, f"scan_join disagrees with its plain version ({kind} {name} "
                      f"batch {batch})")
                w = k4_work(fp.spec, caps, fp.operands, qbuf)
                ops_ms = w["ops"] / (ALU_LANES * rates["sms"] * rates["clock_hz"]) * 1e3
                launch = K.prepare_launch(fp.spec, caps, *fp.operands, qbuf)[0]
                entries.append(timed(
                    "K4", "scan_join_kernel",
                    lambda _, fp=fp, caps=caps, qbuf=qbuf: K.scan_join(
                        fp.spec, caps, *fp.operands, qbuf),
                    lambda _, fp=fp, caps=caps, qbuf=qbuf: K.scan_join_plain(
                        fp.spec, caps, *fp.operands, qbuf),
                    f"{kind} 1M {name}: B={qbuf.shape[0]},R={R},caps={list(caps)}",
                    nbytes=w["nbytes"], ops_ms=ops_ms, plain_reps=10, reps=50, bare=launch,
                    stage0_loads=stage0,
                    search_rounds=w["rounds"], key_sectors=w["sectors"],
                    prim_sectors=w["prim_sectors"], gathered=w["gathered"],
                    sort_cx=w["cx"]))
    return dict(err=err, timings=entries)


def _results_equal(a, b, batch) -> bool:
    import numpy as np

    return bool(np.array_equal(a.counts, b.counts)) and all(
        a.ids(i) == b.ids(i) for i in range(batch))


def phase_serve(stores):
    """The six query classes at batch 1, 8, 64 and 4096: rows across
    devices and against the oracle, then the 1M stores' throughput and
    latency on the card with K4's launches counted.  Returns K4's launches
    in the 1M serving run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import scan_join as K
    from repro_torch.serve import bench, oracle_select, parse_select
    from repro_torch.serve.exec import get_executor

    # rows: the card against the CPU at both tiers, a sample against the oracle
    for n_rows in (ROWS_SMALL, ROWS_PAPER):
        for kind in ("SOM", "OJM"):
            gpu, cpu = (stores[(kind, n_rows, d)] for d in ("cuda", "cpu"))
            p0, classes = bench._classes(gpu)
            check((p0, classes) == bench._classes(cpu), "classes differ across devices")
            for name, qtext in classes:
                for batch in SERVE_BATCHES:
                    res = {}
                    for d, st in (("cuda", gpu), ("cpu", cpu)):
                        ex = get_executor(st)
                        plan, batches, fops = bench._encoded_batches(ex, qtext, p0, batch, 1, 2)
                        res[d] = ex.execute_encoded(plan, batches[0], fops)
                    check(_results_equal(res["cuda"], res["cpu"], batch),
                          f"{kind} {n_rows} {name} batch {batch}: card and CPU rows differ")
                if n_rows == ROWS_SMALL:
                    q = parse_select(qtext)
                    got = get_executor(gpu).solve(q).rows(0)
                    check(got == oracle_select(cpu, q),
                          f"{kind} 100K {name}: rows differ from oracle_select")
            log(f"{kind} {n_rows}: rows of every class at batch {SERVE_BATCHES} equal on the "
                f"card and the CPU" + (", and oracle_select's for one query a class"
                                       if n_rows == ROWS_SMALL else ""))

    # throughput and latency over the 1M stores on the card: serve/bench.py's
    # own loop (per-dispatch latency histograms), every class at batch 1, 8,
    # 64 and 4096, and its small-batch section (single and bgp3, batch 1-64)
    K.launches = 0
    for kind in ("SOM", "OJM"):
        report = bench.bench_serve(stores[(kind, ROWS_PAPER, "cuda")],
                                   batch_sizes=SERVE_BATCHES, target_queries=1 << 15)
        for section in ("classes", "smallbatch"):
            for name, cls in report[section].items():
                for batch, r in cls["batches"].items():
                    fast = (f", {r['fastpath_dispatches']} through the fast path"
                            if "fastpath_dispatches" in r else "")
                    log(f"serve {kind} 1M {section} {name} batch {batch}: "
                        f"{r['queries_per_s']:.1f} queries/s, p50 {r['latency_p50_ms']:.4f} ms, "
                        f"p99 {r['latency_p99_ms']:.4f} ms per dispatch "
                        f"({r['n_batches']} dispatches{fast})")
    launches = K.launches
    log(f"K4 launches during the 1M serving run: {launches}")
    check(launches > 0, "scan_join was never launched on the serving path at batch <= 64")

    # the card's busy share in steady windows: the fast path, and the general
    # path at batch 1 and at its largest batch.  A window whose profile holds
    # no device event at all is run again, at most three times.
    for kind, name, batch in (("OJM", "bgp3", 64), ("OJM", "union", 1),
                              ("OJM", "union", 4096)):
        store = stores[(kind, ROWS_PAPER, "cuda")]
        ex = get_executor(store)
        p0, classes = bench._classes(store)
        plan, batches, fops = bench._encoded_batches(ex, dict(classes)[name], p0, batch,
                                                     8 if batch == 4096 else 32, 4)
        ex.execute_encoded(plan, batches[0], fops)
        dev = []
        for _ in range(3):
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for consts in batches:
                        ex.execute_encoded(plan, consts, fops)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
            except Exception as e:  # a measurement the card could not give
                log(f"  torch.profiler failed ({type(e).__name__}: {e})")
            if dev:
                break
        if not dev:
            log(f"serve {kind} {name} batch {batch}: device busy share not measured")
            continue
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
        k4 = sum(e.time_range.elapsed_us() for e in dev if "scan_join" in e.name) / 1e6
        log(f"serve {kind} 1M {name} batch {batch}, {len(batches)} dispatches: device busy "
            f"{busy:.6f} s of {wall:.6f} s wall ({100 * busy / wall:.3f}%), {len(dev)} "
            f"device events ({len(dev) / len(batches):.0f} a dispatch), K4 {k4:.6f} s")
    return launches


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
        from repro_torch.kernels import bucket_dedup, hash_mix, nested_join

        log("phase 1: device and toolchain")
        smi, rates = phase_device()
        log("phase 2: build the kernels")
        phase_build()
        log("phase 3: testbeds")
        beds = make_testbeds()
        log("phase 4: kernels against their plain versions on the card")
        kres = phase_kernels(beds, rates)
        log("phase 5: rdfize on the card (and the small tier on the CPU)")
        mods = {"hash_mix": hash_mix, "bucket_dedup": bucket_dedup, "nested_join": nested_join}
        launches = phase_rdfize(beds, mods)
        log("phase 6: rdfize --emit kgz on the card (and the small tier on the CPU)")
        paths, kgz_launches = phase_kgz(beds, mods)
        for name, n in kgz_launches.items():
            launches[name] += n
        stores = open_stores(paths)
        log("phase 7: K4 against its plain version on the card")
        kres["scan_join"] = phase_k4(stores, rates)
        log("phase 8: serving the bench classes on the card")
        launches["scan_join"] = phase_serve(stores)
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
        "nested_join": ("src/repro_torch/csrc/nested_join.cu",
                        "src/repro/kernels/nested_join.py:59"),
        "scan_join": ("src/repro_torch/csrc/scan_join.cu",
                      "src/repro/kernels/scan_join.py:309"),
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

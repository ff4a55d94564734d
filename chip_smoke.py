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
     issues to); K2 is also held on a sparse and a dense raw layout, and one
     whole ``radix_dedup_insert`` and its binning are timed at the OJM
     shape; K3's compiled scan loop is read and counted a pair, and its
     1M launch is checked on its first and its last 65,536 child rows;
  5. drive ``rdfize`` through ``repro_torch.launch.rdfize.main``, each path
     with the kernels' launch counters set to 0 just before it and read just
     after: the optimized engine (sorted PJTT) on every testbed and the
     naive engine on the 1M OJM (the paper's "did not finish" cell); at
     100K the naive engine (SOM; OJM at 20K), the hash PJTT (OJM at 20K)
     and the streamed engine (SOM, OJM).  The 100K runs but the optimized
     OJM's, and the optimized, naive and hash OJM at 20K, are repeated on
     the CPU and their N-Triples must be byte-identical to the card's (the
     streamed OJM at 20K); every 1M output must hold no duplicate line, exactly the
     distinct triples a numpy count of the CSV gives, and the same sorted
     lines as the optimized eager run; a profiled rerun of the optimized
     and the naive OJM 100K runs gives the card's busy share over a whole
     run;
  6. write ``.kgz`` stores with ``rdfize --emit kgz`` on the card at 100K
     rows (SOM and OJM; at 1M phase 5 writes them from its optimized
     results with the calls ``--emit kgz`` makes); the card's bytes must
     equal a ``--device cpu`` run's for SOM at 100K and OJM at 20K;
  7. hold K4 (``scan_join``, the serving fast path) against its plain
     version on the card, exactly, for the ``single`` and ``bgp3`` chains of
     ``serve/bench.py`` at batch 1, 8 and 64 over the 1M stores, at the
     capacities the executor converges to; time it like phase 4 and bound
     it by the 32-byte sectors its searches touch, the gathered columns and
     the outputs, and by its search compares and sort compare-exchanges;
     print its chain of dependent loads (the k-ary searches' and a
     bisection's);
  8. serve the six ``serve/bench.py`` query classes at batch 1, 64 and
     4096: the card's rows must equal the CPU's over the 100K stores at
     batch 1, 64 and 4096 (and the 1M stores at batch 1), and over the
     SOM 100K and OJM 20K stores a query a class must equal
     ``oracle_select``'s; then ``serve.bench.bench_serve`` over the 1M
     stores on the card (K4's launch count set to 0 just before, and above
     0 just after, or the phase fails) prints queries/s and p50/p99
     dispatch latency per class and batch, and the card's busy share in a
     fast-path window and in general-path windows at batch 1 and 4096;
  9. the paper's Figures 5 and 6 (``bench.paper_figs.sweep``) on the card at
     10K and 100K rows, every kind, duplicate rate, 1 and 2 predicate-object
     maps, optimized and naive: each 10K cell's triples and φ statistics
     equal a CPU run's, and ``bench.op_model`` at 10K gives the CPU's φ;
     ``examples/kg_biomedical.py`` at 10K rows on the card and the CPU:
     the same triples, counts and φ ratios;
 10. a live store over the 100K OJM store: 10,000 inserts (new terms among
     them) and 10,000 deletes (re-inserts and duplicates among them); the
     six bench classes at batch 1, 64 and 4096 through the overlay equal a
     from-scratch build of the mutated set; a ``save_delta`` /
     ``load_chain`` round trip; compaction byte-identical to that build;
     the same sequence on the CPU gives the card's rows and bytes;
 11. ``rdfize --emit kgz --shards 4`` at 100K OJM, serial (K1/K2 counted)
     and with 2 spawned workers (the same bytes); at 20K the card's bytes
     equal the CPU's; the shards' union is the unsharded
     store, each triple on its subject's shard; ``launch.query`` and the
     shard session answer the six classes at batch 1 and 64 as the
     unsharded store does;
 12. a ``KGServer`` over the 1M OJM store with a client (the six classes,
     round-trip p50/p99 at batch 1, a live insert/delete round trip), then
     a ``Coordinator`` over the 4 100K shards in spawned server processes; K4's
     launch count is set to 0 before and must be above 0 after;
 13. ``bench.dedup_gather.run`` at its defaults (vocab 1M, dim 64, 262,144
     ids, duplicate factors 1/4/16/64): the values equal a plain
     ``index_select``, the distinct count numpy's; Wide & Deep at full
     width (40 fields x 2^20 x 32) at ``serve_p99`` (512) and ``serve_bulk``
     (262,144) batches of Zipf(1.3) ids, plain and deduplicated (the same
     logits, bit for bit; 64 warm forwards each timed), a retrieval over
     1,000,000 candidates, and the ``serve_p99`` logits against a CPU copy
     of the weights (rtol 1e-5, atol 1e-6);
 14. the distributed PTT/PJTT with 8 shards stacked on the card: 2^22
     ``mix64`` keys (75% duplicates) in two batches against a numpy
     first-occurrence oracle, 2^16 keys against a CPU run, and the PJTT
     over the 1M OJM join against the single-device ``pjtt.probe_sorted``;
 15. the runner (``python -m repro_torch.bench.run``) sections ``dedup``,
     ``live`` and ``shard`` at the JAX package's sizes, the kernels' counts
     set to 0 before each: the reports' keys equal the committed
     ``BENCH_live.json`` / ``BENCH_shard.json``'s, routed queries touch one
     shard at 2 and 4 shards, and K4 runs in the shard section;
 16. Wide & Deep training through ``configs.cells.recsys_train_step`` at full
     width (40 fields x 2^20 x 32, batch ``train_batch`` = 65,536, Zipf(1.3)
     ids), plain and with ``dedup_cap``, from the same seeded weights: step,
     forward+backward and AdamW ms by CUDA events over 8 steps after 2
     warm-up, peak memory, every loss finite and falling, plain and dedup
     within rtol 1e-4 a step, no K1-K4 launch; at a cut size (vocab 2^16,
     batch 4,096) two steps against a CPU copy, ``grad_accum`` 4 against 1,
     a ``compress=True`` step and a checkpoint round trip through a failed
     step (loss within rtol 1e-5, grad_norm 1e-3, params within 5% of each
     leaf's update in the 2-norm);
 17. the LM family at its published widths in bf16 (``phase_lm``):
     qwen2.5-3b at full depth serves 4 requests (prompt 512, 64 tokens)
     through ``examples/serve_lm.py`` (the cache filled by ``decode_step``
     held to the prefill's logits), ``prefill_32k`` at batch 1 and
     ``decode_32k`` at batch 32 over a seeded 32,768-slot cache;
     mixtral-8x7b at 8 of its 32 layers ``decode_32k`` at batch 128,
     ``long_500k`` at batch 1 (a 4,096-slot ring) and ``prefill_32k`` at
     batch 1; each against its bound (bytes at 3.35 TB/s, operations at
     989 TFLOP/s), the stages of a decode step and a prefill (CUDA events
     around attention, cache write and MoE; kernels by ``torch.profiler``),
     and in fp32 at full width (qwen 2 layers, mixtral 1) the card against
     the CPU (logits within 1e-4 of their largest, routing equal); no
     K1-K4 launch;
 18. LM training (``phase_lm_train``): qwen2.5-3b at full width, all 36
     layers, bf16, per-layer remat, through ``configs.cells.lm_train_step``
     at batch 3 x 4,096 (``train_4k`` cut from 256): step, forward+backward
     and AdamW ms, peak memory and a falling loss beside their bounds;
     remat off against on at 2 and 4 layers; in fp32 at 2 layers, two
     steps on the card against the CPU; no K1-K4 launch;
 19. GNN training (``phase_gnn``): the four GNNs at their published widths
     on all 16 ``GNN_SHAPES`` cells through ``configs.cells.gnn_train_step``
     (graphs cut by ``GNN_CUTS`` only where the card cannot hold them):
     step ms, peak memory and loss beside a bound, the small cells' 12
     losses held to JAX's from the same weights; the smoke configs in
     fp32 on the card against the CPU; a ``NeighborSampler`` batch at
     ``minibatch_lg``'s fanout, its dedup ratio; no K1-K4 launch;
 20. the dry-run (``phase_dryrun``): ``launch.dryrun`` on the local
     one-card mesh for ``wide-deep/train_batch``, ``gat-cora/full_graph_sm``
     and ``wide-deep/serve_p99`` at full width, each cell also run for real
     once: the traced flops equal ``FlopCounterMode`` over the real run
     exactly, the traced peak is within 10% of ``max_memory_allocated``;
     ``rdfizer/shuffle_dedup`` run for real, 2^24 keys over the single-pod
     mesh's 256 shards stacked on the card (2^22 slots each), its ``is_new``
     count equal to a ``torch.unique`` count of the valid keys; qwen2.5-3b
     ``decode_32k`` traced, which does not fit one card; each cell's
     collectives a device (the sharded trace over a fake process group, JAX's
     byte rule) and their link term printed on the local and 16x16 meshes;
     NequIP, Equiformer and MeshGraphNet ``ogb_products`` at their full
     widths and edge counts, one layer, traced on the 16x16 mesh (their
     per-edge ops on each rank's edge block: the phase fails on an error
     or an empty count); mixtral-8x7b ``train_4k``'s and ``prefill_32k``'s
     (batch waves of 8 rows over 16 data ranks) collectives on 16x16 held
     within 0.67-1.5 of JAX's (``MIXTRAL_JAX_16X16``, bf16 at XLA:CPU's 4
     bytes on both sides), and gemma-2b ``prefill_32k``'s (8 heads and 1
     kv head over 16 ``model`` ranks) within 0.9-1.1 (``GEMMA_JAX_16X16``);
     the phase's time logged; no K1-K4 launch;
 21. collectives across ranks (``phase_collectives``): 4 spawned ranks of a
     (2, 2) ``ProcessMesh`` on the one card (``launch.mesh.run_ranks``; gloo
     on CUDA tensors, the ranks sharing the card; backend, world size and
     card count logged): the shuffle PTT with 2^24 ``mix64`` keys (75%
     duplicates) and 2^22 slots a rank, ``is_new`` equal to a
     ``torch.unique`` count and tables, ``is_new`` and flag equal to the
     stacked arm's at ``n_shards = 4`` bit for bit; the PJTT and the probe
     over the 1M OJM join equal to the stacked arm's and to phase 14's rows;
     Wide & Deep at full width at ``serve_p99``, plain and with
     ``dedup_cap``, its gathered logits against the one-process forward
     (rtol 1e-5, atol 1e-6); qwen2.5-3b's 151,936 x 2,048 table through
     ``embed`` (exact) and ``tied_logits``; one mixtral-8x7b MoE layer in
     bf16, plain and with the int8 gather, and in fp32 at a capacity that
     drops no token against ``_forward_local``; each arm's live collectives
     on every rank (the dry-run's counter) equal to its sharded trace's on a
     (2, 2) accounting mesh, kinds, counts and bytes; no K1-K4 launch;
 22. print the kernels line (one JSON object, all four kernels), the card
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
T0 = time.perf_counter()
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
    """One line, prefixed with the seconds since the script started (the
    phases' time budget is read off these)."""
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}] {msg}", flush=True)


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


DRYRUN_CELLS = ("wide-deep/train_batch", "gat-cora/full_graph_sm", "wide-deep/serve_p99")
DRYRUN_PEAK_RTOL = 0.10  # the traced peak against the card's, of the card's
EDGE_SPLIT_GNNS = ("nequip", "equiformer-v2", "meshgraphnet")  # ogb_products, one layer
# JAX's collective bytes a device for mixtral-8x7b train_4k and prefill_32k
# (its batch of 32 in 4 waves of 8 rows, fewer than the 16 data ranks) on
# the 16x16 mesh (scripts/collectives_vs_jax.py --mesh single, on the CPU,
# bf16 at XLA:CPU's 4 bytes; extrapolated from L=1 and L=2), and the band
# the port's are held to
MIXTRAL_JAX_16X16 = {"train_4k": 593_539_565_360, "prefill_32k": 881_680_312_320}
VS_JAX = (0.67, 1.5)
# gemma-2b prefill_32k's (8 heads, 1 kv head: the head views factor model
# over the heads and the head dim, as GSPMD does), the same way, held closer
GEMMA_JAX_16X16 = {"prefill_32k": 46_846_689_280}
VS_JAX_HEADS = (0.9, 1.1)


def phase_dryrun(kernel_mods):
    """Phase 20: ``launch.dryrun`` on the local one-card mesh, held to real
    runs of the same cells: exact flops, the traced peak within
    ``DRYRUN_PEAK_RTOL`` of ``max_memory_allocated`` (less what was
    allocated besides the args: the cuBLAS workspace and earlier phases'
    leftovers), and the real run's counted bytes and live peak equal to the
    trace's; the rdfizer cell run for real on the single-pod mesh's 256
    shards stacked on the card; qwen2.5-3b ``decode_32k`` traced."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.train.tree import leaves

    reset(kernel_mods)
    start = time.perf_counter()
    mesh = make_local_mesh()
    hbm = torch.cuda.get_device_properties(0).total_memory
    for cell in DRYRUN_CELLS:
        arch, shape = cell.split("/")
        res = dryrun.run_cell(arch, shape, mesh, "local", device=CARD, hbm_bytes=hbm)
        check(res["status"] == "ok" and res["fits"], f"{cell}: {res}")
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        spec = registry.build_cell(arch, shape, mesh, device=CARD, fake=False)
        arg_bytes = torch.cuda.memory_allocated() - before
        spec.fn(*spec.args)  # warm-up: the cuBLAS workspace, lazy state
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - arg_bytes
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        real = dryrun.measure(spec)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - other
        traced, flops, out = res["memory"]["peak_bytes"], real["flops"], real["out"]
        rel = abs(traced - peak) / peak
        check(flops == res["flops_global"],
              f"{cell}: traced flops {res['flops_global']:.6e}, the real run's {flops:.6e}")
        check(real["bytes_accessed"] == res["bytes_accessed_global"]
              and real["peak_bytes"] == traced,
              f"{cell}: the real run's counted bytes {real['bytes_accessed']:.6e} and live "
              f"peak {real['peak_bytes']} against the trace's")
        check(rel <= DRYRUN_PEAK_RTOL,
              f"{cell}: traced peak {traced} B, the card's {peak} B ({rel:.3%})")
        check(all(bool(torch.isfinite(t).all()) for t in leaves(out)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()),
              f"{cell}: a non-finite output")
        log_collectives(cell, "local", res)
        log(f"dry-run {cell}: flops {res['flops_global']:.6e} (traced) = {flops:.6e} (run), "
            f"bytes accessed {res['bytes_accessed_global']:.4e}, peak traced {traced / 1e9:.4f}"
            f" GB against the card's {peak / 1e9:.4f} GB ({rel:.3%}; args "
            f"{arg_bytes / 1e9:.4f} GB), trace {res['trace_s']:.3f} s, run {run_ms:.1f} ms "
            f"(under the counters), fits {res['fits']}")
        del spec, out
        torch.cuda.empty_cache()

    pod = make_production_mesh()
    for cell in DRYRUN_CELLS:
        log_collectives(cell, "single_pod_16x16", dryrun.cell_collectives(*cell.split("/"), pod))
    spec = registry.build_extra_cells(pod, device=CARD, fake=False)[0]
    res = dryrun.run_extra(spec, pod, "single_pod_16x16")
    log_collectives("rdfizer/shuffle_dedup", "single_pod_16x16", res)
    del spec
    torch.cuda.empty_cache()
    check(res["n_new"] == res["n_distinct"] and not res["overflow"],
          f"rdfizer/shuffle_dedup: {res}")
    log(f"dry-run rdfizer/shuffle_dedup, run on the card: {res['n_keys']} keys over "
        f"{res['devices']} shards stacked (2^22 slots each), {res['run_s']:.3f} s, peak "
        f"{res['peak_bytes'] / 1e9:.3f} GB, is_new {res['n_new']} = {res['n_distinct']} "
        f"distinct valid keys (torch.unique), overflow {res['overflow']}")

    res = dryrun.run_cell("qwen2.5-3b", "decode_32k", mesh, "local", device=CARD,
                          hbm_bytes=hbm)
    check(res["status"] == "ok" and not res["fits"],
          f"qwen2.5-3b/decode_32k: expected not to fit one card at batch 128: {res}")
    log_collectives("qwen2.5-3b/decode_32k", "local", res)
    log_collectives("qwen2.5-3b/decode_32k", "single_pod_16x16",
                    dryrun.cell_collectives("qwen2.5-3b", "decode_32k", pod))
    log(f"dry-run qwen2.5-3b/decode_32k (batch 128, 32,768 slots): fits {res['fits']}, peak "
        f"{res['memory']['peak_bytes'] / 1e9:.3f} GB (args "
        f"{res['memory']['argument_size_in_bytes'] / 1e9:.3f} GB) against "
        f"{hbm / 1e9:.3f} GB, flops {res['flops_global']:.4e}, trace {res['trace_s']:.3f} s")
    t0 = time.perf_counter()
    phase_dryrun_faults(pod)
    log(f"dry-run phase: the sharded traces against JAX {time.perf_counter() - t0:.1f} s, the "
        f"phase {time.perf_counter() - start:.1f} s")
    launches = counts(kernel_mods)
    check(not any(launches.values()), f"the dry-run phase launched K1-K4: {launches}")


def phase_dryrun_faults(pod) -> None:
    """Phase 20's sharded traces that once failed or strayed from JAX's on
    this torch: NequIP, Equiformer and MeshGraphNet ``ogb_products`` (one
    layer at full width and edge count, the edges split over the data
    axes) counted on 16x16, mixtral-8x7b ``train_4k``'s and
    ``prefill_32k``'s totals there against JAX's, and gemma-2b
    ``prefill_32k``'s (its heads fewer than the ``model`` ranks) against
    JAX's within ``VS_JAX_HEADS``."""
    import dataclasses

    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import cells, registry
    from repro_torch.launch import dryrun

    shape = registry.GNN_SHAPES["ogb_products"]
    for arch in EDGE_SPLIT_GNNS:
        cfg = dataclasses.replace(registry.gnn_cell_config(arch, "ogb_products"), n_layers=1)

        def build(arch=arch, cfg=cfg):
            return cells.gnn_train_cell(arch, cfg, pod, n=shape["n"], e=shape["e"],
                                        d_feat=shape["d_feat"], task=shape["task"],
                                        n_classes=shape["n_classes"], shard_edges=True,
                                        shape_name="ogb_products")

        t0 = time.perf_counter()
        coll = dryrun.sharded_collectives(build, pod)  # an error fails the phase
        check(bool(coll["counts"]) and coll["total_bytes"] > 0,
              f"{arch}/ogb_products@single_pod_16x16: no collectives counted: {coll}")
        replicated = coll.pop("replicated_for")
        log_collectives(f"{arch}/ogb_products (1 layer, {shape['e']:,} edges)",
                        "single_pod_16x16", {"collectives": coll, "replicated_for": replicated})
        log(f"dry-run {arch}/ogb_products@single_pod_16x16: sharded trace "
            f"{time.perf_counter() - t0:.1f} s, no collectives_error")

    def xla_cpu_bytes(x) -> int:  # bf16 at 4 bytes, as XLA's CPU compile widens it
        return sum(t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
                   for t in tree_leaves(x) if isinstance(t, torch.Tensor))

    held_to = [("mixtral-8x7b", shape_name, want, VS_JAX)
               for shape_name, want in MIXTRAL_JAX_16X16.items()]
    held_to += [("gemma-2b", shape_name, want, VS_JAX_HEADS)
                for shape_name, want in GEMMA_JAX_16X16.items()]
    for arch, shape_name, want, band in held_to:
        held, dryrun._tensor_bytes = dryrun._tensor_bytes, xla_cpu_bytes
        t0 = time.perf_counter()
        try:
            res = dryrun.cell_collectives(arch, shape_name, pod)
        finally:
            dryrun._tensor_bytes = held
        got = res["collectives"]["total_bytes"]
        ratio = got / want
        log(f"dry-run {arch}/{shape_name}@single_pod_16x16 (bf16 at XLA:CPU's 4 bytes): "
            f"port {got:,} B a device against JAX's {want:,} B, port / JAX {ratio:.3f} (" +
            ", ".join(f"{k} {v:,}" for k, v in sorted(res["collectives"]["bytes_by_kind"].items()))
            + f"), sharded traces {time.perf_counter() - t0:.1f} s")
        check(band[0] <= ratio <= band[1],
              f"{arch}/{shape_name}@single_pod_16x16: port / JAX {ratio:.3f} outside {band}")


def log_collectives(cell: str, mesh_name: str, res: dict) -> None:
    """A dry-run record's collectives a device and their link term."""
    from repro_torch.bench.roofline import LINK_BW

    coll = res["collectives"]
    check(coll is not None and set(coll) >= {"bytes_by_kind", "counts", "total_bytes"},
          f"{cell}@{mesh_name}: no collectives record")
    kinds = ", ".join(f"{k} {coll['counts'][k]} x {coll['bytes_by_kind'][k]:,} B"
                      for k in sorted(coll["counts"])) or "none"
    log(f"dry-run {cell}@{mesh_name} collectives a device: {kinds}; total "
        f"{coll['total_bytes']:,} B, t_collective {coll['total_bytes'] / LINK_BW:.6e} s at "
        f"{LINK_BW / 1e9:.0f} GB/s (replicated for {res['replicated_for'] or 'no op'})")


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
        # design's own traffic reads a sector of each array a probe (no
        # cache hit counted) and writes one of each a new key
        lanes, keyed = b.khi.numel(), int(b.kval.sum())
        sectors = stats["read_sectors"] + stats["write_sectors"]
        design = lanes * 2 + keyed * 8 + (stats["probes"] + int(want[2].sum())) * 2 * 32
        ctas = bucket_dedup.ctas_per_sm(b.khi.shape[1], table.hi.shape[1])
        log(f"K2 {name}: {ctas} CTAs of the kernel an SM; the timings' fresh table "
            "is a clone made just before each launch, which leaves part of it in L2")
        k2_entries.append(timed(
            "K2", "bucket_dedup_kernel",
            lambda t: bucket_dedup.bucket_dedup(b.khi, b.klo, b.kval, *t),
            lambda t: bucket_dedup.bucket_dedup_plain(b.khi, b.klo, b.kval, *t),
            f"{name}:{table.n_parts}x{b.khi.shape[1]} lanes,"
            f"{table.n_parts}x{table.hi.shape[1]} slots",
            nbytes=lanes * 2 + keyed * 8 + sectors * 2 * 32 + table.n_parts,
            ops_ms=stats["probes"] * OPS_PER_PROBE / (
                ALU_LANES * rates["sms"] * rates["clock_hz"]) * 1e3,
            setup=fresh, keys=keyed, probes=stats["probes"], rounds=stats["rounds"],
            sectors=sectors, ctas_per_sm=ctas, design_bytes=design,
            design_ms=design / HBM_BYTES_PER_S * 1e3))
        if name == "ojm_prefilled":
            # the whole PTT insert the engine calls, and its host-side binning
            # alone, by CUDA events on the same fresh tables
            insert_ms = cuda_ms(lambda t: ops.radix_dedup_insert(
                ops.RadixTable(*t), hi, lo, valid), fresh, reps=5)
            bin_ms = cuda_ms(lambda _: ops.bin_lanes(hi, lo, valid, table.n_parts), reps=5)
            k2_entries[-1].update(radix_insert_ms=insert_ms, bin_lanes_ms=bin_ms)
            log(f"K2 ojm_prefilled: one ops.radix_dedup_insert {insert_ms:.5f} ms "
                f"(CUDA events), of which ops.bin_lanes {bin_ms:.5f} ms")
    # raw layouts the engine's binning does not make: a sparse OJM-like one
    # (scattered valid lanes, not a prefix) and a dense one whose valid lanes
    # exceed the LIST a CTA keeps in shared memory, at a load of many rounds
    for name, (n_parts, part_len, vfrac) in (("sparse", (16, 43_520, 0.05)),
                                             ("dense", (2, 12_000, 1.0))):
        khi, klo, valid = keys(n_parts * part_len, 10**9, vfrac)
        khi, klo, valid = (x.view(n_parts, part_len) for x in (khi, klo, valid))
        t = torch.full((2, n_parts, bucket_dedup.SLICE), -1, dtype=torch.int32, device=dev)
        stats = {}
        got = bucket_dedup.bucket_dedup(khi, klo, valid, t[0].clone(), t[1].clone())
        want = bucket_dedup.bucket_dedup_plain(khi, klo, valid, t[0].clone(), t[1].clone(),
                                               stats)
        torch.cuda.synchronize()
        e = max_abs_err(zip(got, want))
        k2_err = max(k2_err, e)
        log(f"K2 bucket_dedup {name}: parts={n_parts} part_len={part_len} "
            f"cap={bucket_dedup.SLICE} keys={int(valid.sum())} new={int(got[2].sum())} "
            f"overflow={bool(got[3].any())} rounds={stats['rounds']} "
            f"probes={stats['probes']}: max_abs_err {e}")
        check(e == 0, f"bucket_dedup disagrees with its plain version ({name})")
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


_EXPECTED: dict = {}  # testbed directory -> expected_triples (one count a testbed)


def _expected_triples(d: str, tb) -> dict[str, int]:
    if d not in _EXPECTED:
        _EXPECTED[d] = expected_triples(tb, d)
    return _EXPECTED[d]


def expected_triples(tb, d) -> dict[str, int]:
    """Distinct (subject, object) value pairs per predicate, by numpy from
    the written CSV files (plain comma-separated cells, no quoting).  Each
    column's strings are coded once (``np.unique``), and the join expands
    the codes, not the strings."""
    import numpy as np

    def read(path):  # one split over the whole file: every row has every column
        with open(path, encoding="utf-8") as f:
            header, body = f.read().split("\n", 1)
        names = header.split(",")
        cells = np.array(body.removesuffix("\n").replace("\n", ",").split(","))
        cells = cells.reshape(-1, len(names))
        return {h: cells[:, i] for i, h in enumerate(names)}

    def codes(a):
        return np.unique(a, return_inverse=True)[1]

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
    subj = codes(child["MUTATION_ID"])
    if tb.parent is None:
        for pom in tm.poms:
            out[pom.predicate] = _distinct_pairs(subj, codes(child[pom.object_map.reference]))
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
    n = _distinct_pairs(subj[rows], codes(parent["EXON_ID"])[prow])
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
    """Returns the launches, and the 1M ``.kgz`` paths: each written from
    the optimized 1M run's result by the two calls ``rdfize --emit kgz``
    makes (``KGResult.to_store`` on the card, ``persist.save``), where a
    second 1M ingest each ran until the run needed the time (PERF.md)."""
    from repro_torch.kg import persist
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
    digests, kgz = {}, {}
    for n_rows in (ROWS_SMALL, ROWS_PAPER):  # the optimized eager engine
        for kind in ("SOM", "OJM"):
            result, out = run_on_card(kind, n_rows, "optimized")
            if n_rows == ROWS_PAPER:
                check_paper_tier(beds, kind, "optimized", result, out, digests)
                tb, d, _ = beds[(kind, n_rows)]
                kgz[(kind, n_rows)] = os.path.join(d, "kg-cuda-0.kgz")
                t0 = time.perf_counter()
                persist.save(result.to_store(device=CARD), kgz[(kind, n_rows)])
                log(f"{tb.name}: .kgz written from the optimized run's result (to_store on "
                    f"the card, persist.save) in {time.perf_counter() - t0:.3f} s, "
                    f"{os.path.getsize(kgz[(kind, n_rows)])} bytes")
            elif kind == "SOM":  # the OJM against the CPU at 20K below
                same_bytes_as_cpu(kind, n_rows, "optimized", out)
            os.remove(out)

    # the naive OJM at the paper's tier (its "did not finish" cell) against
    # the optimized eager run's sorted lines; then the paths of slice 2 on
    # the small tier, cuda against cpu (the 1M hash-PJTT, streamed and naive
    # SOM reruns, and the hash PJTT's, the optimized and the streamed OJM's
    # CPU runs at 100K, were cut to keep the run inside its time: PERF.md)
    result, out = run_on_card("OJM", ROWS_PAPER, "naive")
    check_paper_tier(beds, "OJM", "naive", result, out, digests)
    os.remove(out)
    for path, kind, n_rows in (("optimized", "OJM", ROWS_NAIVE_CPU),
                               ("naive", "SOM", ROWS_SMALL), ("naive", "OJM", ROWS_NAIVE_CPU),
                               ("hash", "OJM", ROWS_NAIVE_CPU), ("stream", "SOM", ROWS_SMALL),
                               ("stream", "OJM", ROWS_NAIVE_CPU)):
        _, out = run_on_card(kind, n_rows, path)
        same_bytes_as_cpu(kind, n_rows, path, out)
        os.remove(out)

    # the small tier once more under torch.profiler (CUDA activity only):
    # how busy the card is over a whole rdfize run, and on what (these
    # reruns were at 1M rows until the run needed the time: PERF.md)
    import torch
    from torch.profiler import ProfilerActivity, profile

    for kind, path in (("SOM", "optimized"), ("OJM", "optimized"), ("OJM", "naive")):
        tb, d, _ = beds[(kind, ROWS_SMALL)]
        log(f"profiled rerun of {tb.name} {path}:")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, out = run(kind, ROWS_SMALL, path, "cuda")
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
    return totals, kgz


def check_paper_tier(beds, kind, path, result, out, digests) -> None:
    """A 1M output: no duplicate line, per-predicate counts equal to numpy's
    distinct pairs, and the optimized eager run's sorted lines."""
    tb, d, _ = beds[(kind, ROWS_PAPER)]
    with open(out, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(len(lines) == result.n_triples, f"{tb.name} {path}: line count")
    check(len(set(lines)) == len(lines), f"{tb.name} {path}: duplicate N-Triples lines")
    want = _expected_triples(d, tb)  # one count a testbed, for each engine's run
    got = {p: st.n_unique for p, st in result.stats.items()}
    check(got == want, f"{tb.name} {path}: triples per predicate {got} != numpy {want}")
    digest = sorted_digest(lines)
    ref = digests.setdefault(kind, digest)  # the optimized run comes first
    check(digest == ref, f"{tb.name} {path}: sorted lines differ from the optimized run's")
    log(f"{tb.name} {path}: {len(lines)} distinct lines; per-predicate counts equal "
        f"numpy's distinct pairs from the CSV: {want}; sorted-lines sha256 {digest[:16]} "
        "equals the optimized eager run's")


# ------------------------------------------------------------------ serving

SERVE_BATCHES = (1, 64, 4096)  # (1, 8, 64, 4096) until phase 21 needed the time
K4_BATCHES = (1, 8, 64)
K4_CLASSES = ("single", "bgp3")  # the chain classes the fast path takes
OPS_PER_ROUND = 8  # K4: midpoint, clamp, two compares, the select of lo/hi
OPS_PER_CX_COLUMN = 3  # K4's sort: compare, and a swap's two selects, a column


def phase_kgz(beds, kernel_mods, kgz_1m):
    """``rdfize --emit kgz`` on the card at 100K and 20K; the CPU's bytes
    must equal the card's for SOM at 100K and OJM at 20K (at 100K until the
    run needed the time: PERF.md).  The 1M stores are phase 5's
    (``kgz_1m``).  Returns the .kgz paths and the launches."""
    from repro_torch.launch import rdfize

    paths, totals = dict(kgz_1m), {name: 0 for name in kernel_mods}
    against_cpu = {("SOM", ROWS_SMALL), ("OJM", ROWS_NAIVE_CPU)}
    for kind, n_rows in (("SOM", ROWS_SMALL), ("OJM", ROWS_SMALL), ("OJM", ROWS_NAIVE_CPU)):
        tb, d, _ = beds[(kind, n_rows)]
        out = {}
        for device in (CARD, "cpu") if (kind, n_rows) in against_cpu else (CARD,):
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
        if (kind, n_rows) in against_cpu:
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
    """The six query classes at batch 1, 64 and 4096: rows across
    devices and against the oracle, then the 1M stores' throughput and
    latency on the card with K4's launches counted.  Returns K4's launches
    in the 1M serving run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import scan_join as K
    from repro_torch.serve import bench, oracle_select, parse_select
    from repro_torch.serve.exec import get_executor

    # rows: the card against the CPU at both tiers (at 100K at batch 1, 64
    # and 4096, at 1M at batch 1, to keep the run inside its time: PERF.md),
    # a sample against the oracle
    for n_rows in (ROWS_SMALL, ROWS_PAPER):
        batches_checked = (1, 64, 4096) if n_rows == ROWS_SMALL else (1,)
        for kind in ("SOM", "OJM"):
            gpu, cpu = (stores[(kind, n_rows, d)] for d in ("cuda", "cpu"))
            p0, classes = bench._classes(gpu)
            check((p0, classes) == bench._classes(cpu), "classes differ across devices")
            for name, qtext in classes:
                for batch in batches_checked:
                    res = {}
                    for d, st in (("cuda", gpu), ("cpu", cpu)):
                        ex = get_executor(st)
                        plan, batches, fops = bench._encoded_batches(ex, qtext, p0, batch, 1, 2)
                        res[d] = ex.execute_encoded(plan, batches[0], fops)
                    check(_results_equal(res["cuda"], res["cpu"], batch),
                          f"{kind} {n_rows} {name} batch {batch}: card and CPU rows differ")
            log(f"{kind} {n_rows}: rows of every class at batch {batches_checked} equal on the "
                f"card and the CPU")
    # oracle_select (a plain evaluation, seconds a query on the host) for one
    # query a class over SOM 100K and OJM 20K (100K until the run needed the
    # time: PERF.md)
    for kind, n_rows in (("SOM", ROWS_SMALL), ("OJM", ROWS_NAIVE_CPU)):
        gpu, cpu = (stores[(kind, n_rows, d)] for d in ("cuda", "cpu"))
        p0, classes = bench._classes(gpu)
        for name, qtext in classes:
            q = parse_select(qtext)
            got = get_executor(gpu).solve(q).rows(0)
            check(got == oracle_select(cpu, q), f"{kind} {n_rows} {name}: rows differ from "
                  "oracle_select")
        log(f"{kind} {n_rows}: the card's rows of one query a class equal oracle_select's")

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
                                                     32 if name == "bgp3" else 8, 4)
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


# ------------------------------------------------------------------ slice 6

FIG_SIZES = (10_000, 100_000)  # paper_figs here; the 1M tier: bench.paper_figs --full
FIG_POMS = (1, 2)
LIVE_BATCHES = (1, 64, 4096)
LIVE_B1_TEXTS = 16  # distinct batch-1 overlay queries a class, each checked
LIVE_TIMED = {1: 16, 64: 8, 4096: 4}  # warm overlay dispatches timed a class
N_MUT = 10_000  # the live phase's inserts, and its deletes
N_SHARDS = 4
SERVER_TIMED_PASSES = 1  # timed round trips a class: 1 pass over its texts
SERVER_TEXTS = 16  # round-trip texts a class (64 until the run needed the time: PERF.md)


def reset(kernel_mods) -> None:
    for mod in kernel_mods.values():
        mod.launches = 0


def counts(kernel_mods) -> dict:
    return {name: mod.launches for name, mod in kernel_mods.items()}


def pct(values, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), q))


def phase_paper_figs(kernel_mods):
    """``bench.paper_figs.sweep`` on the card at 10K and 100K rows (every
    kind, both duplicate rates, 1 and 2 predicate-object maps, optimized
    and naive); each 10K cell's triples and statistics equal a CPU run's;
    ``bench.op_model`` at 10K gives the CPU's numbers.  Returns the
    launches."""
    from repro_torch.bench import op_model, paper_figs

    reset(kernel_mods)
    t0 = time.perf_counter()
    rows = paper_figs.sweep(sizes=FIG_SIZES, n_poms_list=FIG_POMS, device=CARD, log=False)
    got = counts(kernel_mods)
    log(f"paper_figs sweep on the card: {len(rows)} cells in "
        f"{time.perf_counter() - t0:.1f} s; launches {got}")
    for name in ("hash_mix", "bucket_dedup", "nested_join"):
        check(got[name] > 0, f"{name} was never launched by the paper_figs sweep")
    cpu = paper_figs.sweep(sizes=FIG_SIZES[:1], n_poms_list=FIG_POMS, device="cpu", log=False)

    def key(r):
        return (r["kind"], r["rows"], r["dup"], r["n_poms"], r["engine"])

    cpu_by = {key(r): r for r in cpu}
    by = {key(r): r for r in rows}
    for r in rows:
        check(r["status"] == "ok", f"paper_figs {key(r)}: {r['status']}")
        other = by[key(r)[:4] + ("naive" if r["engine"] == "optimized" else "optimized",)]
        check(r["n_triples"] == other["n_triples"], f"paper_figs {key(r)}: engines disagree")
        same = ""
        if key(r) in cpu_by:
            c = cpu_by[key(r)]
            check(r["n_triples"] == c["n_triples"] and r["stats"] == c["stats"],
                  f"paper_figs {key(r)}: the card's triples or statistics differ from the CPU's")
            same = "; triples and statistics equal the CPU run's"
        log(f"paper_figs {r['kind']} n={r['rows']} dup={int(r['dup'] * 100)}% "
            f"poms={r['n_poms']} {r['engine']}: {r['time_s']:.4f} s, "
            f"{r['n_triples']} triples{same}")
    om_card = op_model.run(sizes=FIG_SIZES[:1], device=CARD, log=False)
    om_cpu = op_model.run(sizes=FIG_SIZES[:1], device="cpu", log=False)
    check(om_card == om_cpu, "op_model: the card's phi values differ from the CPU's")
    for r in om_card:
        log(f"op_model {r['kind']} n={r['rows']} dup={int(r['dup'] * 100)}%: |Np|={r['Np']} "
            f"|Sp|={r['Sp']} phi={r['phi']} phi_naive={r['phi_naive']} "
            f"ratio={r['ratio']:.1f}x (equal to the CPU run's)")
    for name, n in kg_example(kernel_mods).items():
        got[name] += n
    return got


KG_EXAMPLE_ROWS = 10_000  # 20,000 until phase 21 needed the time


def kg_example(kernel_mods) -> dict:
    """``examples/kg_biomedical.py`` at ``KG_EXAMPLE_ROWS`` rows on the card
    and on the CPU: each testbed's triples (``as_set``) and every printed
    count and phi ratio equal (times masked).  Returns the card run's
    launches."""
    import contextlib
    import io
    import re

    from repro_torch.examples import kg_biomedical

    out = {}
    for dev in (CARD, "cpu"):
        before = counts(kernel_mods)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = kg_biomedical.main(["--rows", str(KG_EXAMPLE_ROWS), "--device", dev])
        wall = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts(kernel_mods).items()}
        lines = [re.sub(r"\s+\d+\.\d+x$", "", re.sub(r"\s*\d+\.\d+s\b", " <s>", line))
                 for line in buf.getvalue().splitlines()]
        out[dev] = (res, lines, buf.getvalue(), wall, launched)
    (rc, lc, text, wall_c, launched), (rh, lh, _, wall_h, _) = out[CARD], out["cpu"]
    check(lc == lh, "kg_biomedical: the card's printed counts or phi ratios differ from the "
          f"CPU's:\n{lc}\n{lh}")
    for kind in rc:
        check(rc[kind][0].as_set() == rh[kind][0].as_set(),
              f"kg_biomedical {kind}: the card's triples differ from the CPU's")
    for name in ("hash_mix", "nested_join"):
        check(launched[name] > 0, f"kg_biomedical on the card never launched {name}")
    print(text, end="", flush=True)
    log(f"kg_biomedical at {KG_EXAMPLE_ROWS} rows: card {wall_c:.2f} s, CPU {wall_h:.2f} s "
        f"wall; every testbed's triples and the printed counts and phi ratios equal the "
        f"CPU run's; launches {launched}")
    return launched


def class_queries(store, batch: int, seed: int = 2):
    """Each ``serve/bench.py`` class as ``batch`` query texts over
    ``store``, the anchor object varied per query as the bench does."""
    from repro_torch.serve import bench

    p0, classes = bench._classes(store)
    some_o = store.decode_term(int(bench._anchor_pool(store, p0, 0)[0]))
    pool = bench._anchor_pool(store, p0, seed)[:batch]
    anchors = [store.decode_term(int(a)) for a in pool]
    return {name: [text.replace(some_o, a) for a in anchors] for name, text in classes}


def run_texts(store, texts, view=None):
    """One micro-batch of signature-equal query texts (over ``view`` when
    given); the result and its wall time in ms."""
    import torch

    from repro_torch.serve import parse_select
    from repro_torch.serve.exec import get_executor

    ex = get_executor(store)
    qs = [parse_select(t) for t in texts]
    t0 = time.perf_counter()
    res = ex.execute(ex.plan(qs[0]), qs, view=view)
    if store.device.type == "cuda":
        torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def row_bag(res, i):
    return sorted(res.rows(i), key=lambda r: tuple((x is None, str(x)) for x in r))


def mutations(store):
    """The live phase's deterministic mutation sequence over ``store``:
    inserts (new subjects and literals on the bench's anchors, new
    combinations of existing terms, duplicates of base triples), deletes
    of 10,000 base triples (the anchors' rows first, some listed twice),
    re-inserts of deleted triples and deletes of inserted ones, as
    ``tests/test_live.py::test_tombstone_resurrect_and_dupes`` does."""
    import numpy as np

    from repro_torch.serve import bench

    preds = bench._workload_preds(store)
    t0, t1, t2 = (store.decode_term(p) for p in preds[:3])
    p0 = preds[0]
    anchors = bench._anchor_pool(store, p0, 2)[:64]
    rng = np.random.default_rng(7)
    dec = store.decode_term

    def trip(r):
        return (dec(int(store.s[r])), dec(int(store.p[r])), dec(int(store.o[r])))

    hot = np.nonzero((store.p == p0) & np.isin(store.o, anchors))[0][: N_MUT // 5]
    rest = rng.permutation(store.n_triples)
    rest = rest[~np.isin(rest, hot)][: N_MUT - len(hot)]
    dels = [trip(int(r)) for r in np.concatenate([hot, rest])]
    ins = []
    for i in range(N_MUT // 4):  # 3 triples a new subject, one a new literal
        s = f"<http://example.org/live/m{i}>"
        ins += [(s, t0, dec(int(anchors[i % len(anchors)]))), (s, t1, f'"live {i}"'),
                (s, t2, dec(int(store.o[rng.integers(0, store.n_triples)])))]
    n_new = len(ins)
    for _ in range(N_MUT * 3 // 20):  # new combinations of existing terms
        a, b = rng.integers(0, store.n_triples, 2)
        ins.append((dec(int(store.s[a])), t1, dec(int(store.o[b]))))
    ins += [trip(int(r)) for r in rng.integers(0, store.n_triples, N_MUT - len(ins))]
    return [("insert", ins), ("delete", dels + dels[: N_MUT // 20]),
            ("insert", dels[: N_MUT // 10]), ("delete", ins[: n_new // 4: 3])]


def apply_mutations(live, ops):
    """Apply ``ops`` to ``live``; returns the model triple set and each
    operation's result and time."""
    model = set(live.rendered_triples())
    done = []
    for op, trips in ops:
        t0 = time.perf_counter()
        res = getattr(live, op)(trips)
        done.append((op, len(trips), res, (time.perf_counter() - t0) * 1e3))
        for t in trips:
            (model.add if op == "insert" else model.discard)(t)
    return model, done


LIVE_ROWS = ROWS_SMALL  # the live store's base (1M until the run needed the time: PERF.md)


def phase_live(stores, paths):
    """A live store over the 100K OJM store: 10,000 inserts (new terms
    among them) and 10,000 deletes with re-inserts and duplicates; the six
    bench classes at batch 1, 64 and 4096 through the overlay equal a
    from-scratch build of the mutated set; a delta-snapshot round trip;
    compaction byte-identical to that build; and the same sequence on the
    CPU gives the card's rows and compacted bytes."""
    from repro_torch.kg import persist
    from repro_torch.kg.store import TripleStore
    from repro_torch.live import LiveStore

    base = stores[("OJM", LIVE_ROWS, "cuda")]
    tier = f"{LIVE_ROWS // 1000}K OJM"
    live = LiveStore(base)
    model, done = apply_mutations(live, mutations(base))
    for op, n, res, ms in done:
        log(f"live {tier} {op} of {n} triples: {res} in {ms:.1f} ms")
    check(set(live.rendered_triples()) == model, "live: the live triple set is not the model's")
    check(live.n_triples == len(model), "live: n_triples")
    t0 = time.perf_counter()
    view = live.view()
    for order in ("spo", "pos", "osp"):
        view.alive(order)
    log(f"live view(): {(time.perf_counter() - t0) * 1e3:.1f} ms ({live.n_delta} delta rows, "
        f"{live.n_tombstones} tombstones, {view.n_terms - base.n_terms} new terms)")
    t0 = time.perf_counter()
    scratch = TripleStore.from_ntriples(sorted(model), device=CARD)
    log(f"from-scratch build of the mutated set ({scratch.n_triples} triples): "
        f"{time.perf_counter() - t0:.2f} s")

    # overlay rows against the rebuilt store's, as bags (overlay term ids
    # append out of rendered order, so tied rows may come in another order).
    # Every batch is run and checked once first, so the timed dispatches
    # after it are warm; batch 1 gives a tail, the larger batches a median
    # and a maximum of a few.
    for batch in LIVE_BATCHES:
        for name, texts in class_queries(base, LIVE_B1_TEXTS if batch == 1 else batch).items():
            groups = [[t] for t in texts] if batch == 1 else [texts]
            n_rows = 0
            for qs in groups:
                res, _ = run_texts(base, qs, view=view)
                want, _ = run_texts(scratch, qs)
                for i in range(len(qs)):
                    check(res.n(i) == want.n(i) and row_bag(res, i) == row_bag(want, i),
                          f"live {name} batch {batch}: overlay rows differ from the "
                          "rebuilt store's")
                n_rows += int(res.counts.sum())
            lat = [run_texts(base, groups[k % len(groups)], view=view)[1]
                   for k in range(LIVE_TIMED[batch])]
            spread = (f"p50 {pct(lat, 50):.3f} ms, p99 {pct(lat, 99):.3f} ms" if batch == 1
                      else f"median {pct(lat, 50):.3f} ms, max {max(lat):.3f} ms")
            log(f"live {tier} overlay {name} batch {batch}: {n_rows} rows equal the rebuilt "
                f"store's; dispatch {spread} over {len(lat)} warm dispatches")

    # the same sequence on the CPU: the card's overlay rows equal its rows
    cpu_base = stores[("OJM", LIVE_ROWS, "cpu")]
    cpu_live = LiveStore(cpu_base)
    apply_mutations(cpu_live, mutations(cpu_base))
    for batch in LIVE_BATCHES:
        for name, texts in class_queries(base, batch).items():
            a, _ = run_texts(base, texts, view=live.view())
            b, _ = run_texts(cpu_base, texts, view=cpu_live.view())
            check(_results_equal(a, b, batch), f"live {tier} {name} batch {batch}: card != CPU")

    # a delta snapshot chained to the served .kgz, resolved back
    parent = paths[("OJM", LIVE_ROWS)]
    delta = os.path.join(os.path.dirname(parent), "live.delta.kgz")
    t0 = time.perf_counter()
    persist.save_delta(live, delta, os.path.basename(parent))
    chain = persist.load_chain(delta, device=CARD)
    log(f"save_delta + load_chain: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"{os.path.getsize(delta)} bytes")
    for name, texts in class_queries(base, 64).items():
        a, _ = run_texts(base, texts, view=live.view())
        b, _ = run_texts(chain.base, texts, view=chain.view())
        check(_results_equal(a, b, 64), f"live {name}: the reloaded chain's rows differ")
    log("the reloaded delta chain answers every class with the live store's rows")

    t0 = time.perf_counter()
    compacted = live.compact()
    log(f"compact {tier} live store: {time.perf_counter() - t0:.2f} s")
    blobs = []
    for st in (compacted, scratch):
        out = os.path.join(os.path.dirname(parent), f"compacted-{len(blobs)}.kgz")
        persist.save(st, out, generation=1)
        with open(out, "rb") as f:
            blobs.append(f.read())
    check(blobs[0] == blobs[1], "compacted store's bytes differ from the rebuilt store's")
    for name, texts in class_queries(scratch, 64).items():
        a, _ = run_texts(compacted, texts)
        b, _ = run_texts(scratch, texts)
        check(_results_equal(a, b, 64), f"live {name}: compacted rows differ")
    log(f"compacted {tier} store: {len(blobs[0])} bytes, equal to the rebuilt store's; rows "
        "equal")

    # the same sequence on the CPU: its compacted bytes equal the card's
    out = os.path.join(os.path.dirname(parent), "compacted-cpu.kgz")
    persist.save(cpu_live.compact(), out, generation=1)
    with open(out, "rb") as f:
        check(f.read() == blobs[0], f"live {tier}: compacted bytes differ between the card and "
              "the CPU")
    log(f"live {tier}: the card's overlay rows (every class, batch 1/64/4096) and compacted "
        "bytes equal the CPU's")


SHARD_ROWS = ROWS_SMALL  # sharded ingest's tier (1M until the run needed the time: PERF.md)
SHARD_BATCH = 16  # the shard session's batch a class (64 until the run needed the time)


def phase_shards(beds, kernel_mods, stores, paths):
    """``rdfize --emit kgz --shards 4`` at 100K OJM, serial (K1/K2 counted)
    and with 2 spawned workers (same bytes); at 20K the card's shard bytes
    equal the CPU's; the shards' union is the unsharded store's triples,
    each on its subject's shard; ``launch.query`` and the shard session
    answer the six classes as the unsharded store does.  Returns the serial
    run's launches and the manifest's path."""
    import contextlib
    import io

    from repro_torch import api
    from repro_torch.api import LocalSession
    from repro_torch.kg import persist
    from repro_torch.launch import query as query_cli
    from repro_torch.launch import rdfize
    from repro_torch.live import LiveStore
    from repro_torch.shard import shard_of_term
    from repro_torch.shard.coordinator import _Item

    def build(n_rows, device, workers):
        tb, d, _ = beds[("OJM", n_rows)]
        out_dir = os.path.join(d, f"shards-{device}-{workers}")
        os.makedirs(out_dir, exist_ok=True)
        manifest = os.path.join(out_dir, "kg.shards.json")
        t0 = time.perf_counter()
        rdfize.main(["--mapping", os.path.join(d, "map.ttl"), "--data-root", d, "--out",
                     manifest, "--device", device, "--emit", "kgz", "--shards",
                     str(N_SHARDS), "--shard-workers", str(workers)])
        wall = time.perf_counter() - t0
        blobs = {}
        for name in ["kg.shards.json"] + [f"kg.shard{i}.kgz" for i in range(N_SHARDS)]:
            with open(os.path.join(out_dir, name), "rb") as f:
                blobs[name] = f.read()
        log(f"rdfize --shards {N_SHARDS} --shard-workers {workers} {tb.name} on {device}: "
            f"{wall:.3f} s end to end, shard bytes "
            f"{[len(blobs[f'kg.shard{i}.kgz']) for i in range(N_SHARDS)]}")
        return manifest, blobs

    reset(kernel_mods)
    manifest, serial = build(SHARD_ROWS, CARD, 0)
    got = counts(kernel_mods)
    log(f"  launches during the serial sharded ingest: {got}")
    for name in ("hash_mix", "bucket_dedup"):
        check(got[name] > 0, f"{name} was never launched by the sharded ingest")
    _, spawned = build(SHARD_ROWS, CARD, 2)
    check(spawned == serial, "sharded ingest: 2 spawned workers wrote other bytes than serial")
    _, tiny_card = build(ROWS_NAIVE_CPU, CARD, 0)
    _, tiny_cpu = build(ROWS_NAIVE_CPU, "cpu", 0)
    check(tiny_card == tiny_cpu, "sharded ingest 20K: the card's bytes differ from the CPU's")
    log(f"{SHARD_ROWS // 1000}K: the manifest and shard bytes of 2 spawned workers equal the "
        f"serial run's; {ROWS_NAIVE_CPU // 1000}K: the card's equal the CPU's")

    unsharded = stores[("OJM", SHARD_ROWS, "cuda")]
    want = set(LiveStore(unsharded).rendered_triples())
    union = 0
    for i, entry in enumerate(persist.load_manifest(manifest)["shards"]):
        trips = LiveStore(persist.open_store(entry["abs_path"], device=CARD)).rendered_triples()
        check(all(shard_of_term(t[0], N_SHARDS) == i for t in trips),
              f"shard {i} holds a triple of another shard's subject")
        check(set(trips) <= want, f"shard {i} holds a triple the unsharded store lacks")
        union += len(trips)
    check(union == len(want), "the shards' triples do not add up to the unsharded store's")
    log(f"the {N_SHARDS} shards hold the unsharded store's {len(want)} triples, each on "
        "its subject's shard")

    single = LocalSession(unsharded)
    for name, texts in class_queries(unsharded, SHARD_BATCH).items():
        outs = []
        for kg in (manifest, paths[("OJM", SHARD_ROWS)]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                query_cli.main(["--kg", kg, "--device", CARD, texts[0]])
            outs.append(buf.getvalue())
        check(outs[0] == outs[1], f"launch.query on the manifest: {name} rows differ")
        with api.connect(manifest, read_only=True, device=CARD) as sess:
            t0 = time.perf_counter()
            replies = sess.group.execute_query_group([_Item(text=t, limit=None) for t in texts])
            ms = (time.perf_counter() - t0) * 1e3
        for t, r in zip(texts, replies):
            w = single.query(t, limit=1000)
            check(not r.get("error") and [tuple(x) for x in r["rows"]] == w.rows
                  and r["n_total"] == w.n_total, f"sharded {name} batch {SHARD_BATCH}: rows differ")
        log(f"sharded {name}: launch.query (batch 1) prints the unsharded store's rows; "
            f"batch {SHARD_BATCH} through the shard session in {ms:.1f} ms equals them")
    return got, manifest


def phase_server(stores, manifest):
    """A ``KGServer`` over the 1M OJM store with a port client: the six
    classes equal in-process rows, round-trip p50/p99 at batch 1 over warm
    passes, a live insert/delete round trip; then a ``Coordinator`` over
    the 4 shards of ``manifest`` (``SHARD_ROWS``) in spawned server
    processes, held to the unsharded store of that tier.  Returns the
    server's K4 launches, which must equal its fast-path dispatches."""
    from repro_torch.api import LocalSession
    from repro_torch.kernels import scan_join as K
    from repro_torch.live import LiveStore
    from repro_torch.obs import get_registry
    from repro_torch.serve import bench
    from repro_torch.serve.client import connect
    from repro_torch.serve.server import KGServer
    from repro_torch.shard.coordinator import (
        Coordinator,
        connect_shard_group,
        spawn_shard_servers,
    )

    store = stores[("OJM", ROWS_PAPER, "cuda")]
    # the in-process replies every round trip is held against, all computed
    # before the launch count is reset: they run on the same card stores and
    # take the fast path (K4) in this process
    texts, want = {}, {}
    for who, st in (("server", store), ("coordinator", stores[("OJM", SHARD_ROWS, "cuda")])):
        texts[who] = class_queries(st, SERVER_TEXTS, seed=3)
        single = LocalSession(st)
        want[who] = {t: single.query(t, limit=1000) for qs in texts[who].values() for t in qs}
    p0 = bench._workload_preds(store)[0]
    pred = store.decode_term(p0)
    obj = store.decode_term(int(bench._anchor_pool(store, p0, 3)[0]))

    def round_trips(c, who, label):
        """A checked warm-up pass over each class's texts, then
        ``SERVER_TIMED_PASSES`` timed and checked passes."""
        for name, qs in texts[who].items():
            lat = []
            for k in range(1 + SERVER_TIMED_PASSES):
                for t in qs:
                    t0 = time.perf_counter()
                    r = c.query(t)
                    if k:
                        lat.append((time.perf_counter() - t0) * 1e3)
                    w = want[who][t]
                    check([tuple(x) for x in r["rows"]] == w.rows and r["n_total"] == w.n_total,
                          f"{label} {name}: the reply differs from the in-process rows")
            log(f"{label} {name} batch 1: {len(qs)} queries answered with the in-process rows; "
                f"p50 {pct(lat, 50):.3f} ms, p99 {pct(lat, 99):.3f} ms over {len(lat)} round "
                "trips after a warm-up pass")

    def fast_dispatches():
        return get_registry().counter("exec.fastpath_dispatches").value

    fast0 = fast_dispatches()
    K.launches = 0
    srv = KGServer(LiveStore(store), port=0, log=False).start()  # the process registry
    try:
        with connect(srv.host, srv.port, timeout=120.0) as c:
            round_trips(c, "server", "server 1M OJM")
            q = texts["server"]["single"][0]
            check(q == f"?s {pred} {obj}", f"server: unexpected single query {q}")
            anchor_row = [tuple(x) for x in c.query(q)["rows"]]
            new = ("<http://example.org/live/server>", pred, obj)
            r = c.insert([list(new)])
            check(r["inserted"] == 1, f"server insert: {r}")
            check((new[0],) in [tuple(x) for x in c.query(q)["rows"]], "server: insert unseen")
            old = (anchor_row[0][0], pred, obj)
            r = c.delete([list(new), list(old)])
            check((r["deleted"], r["tombstoned"]) == (2, 1), f"server delete: {r}")
            after = [tuple(x) for x in c.query(q)["rows"]]
            check(after == anchor_row[1:], "server: the deletes are not reflected")
            log("server live round trip: insert, query, delete (one tombstone), query: as "
                "expected")
    finally:
        srv.stop()
    launches, fast = K.launches, fast_dispatches() - fast0
    log(f"K4 launches by the server: {launches}; its fast-path dispatches "
        f"(exec.fastpath_dispatches): {fast}")
    check(launches > 0, "scan_join was never launched through the server")
    check(launches == fast, "the server's K4 launches differ from its fast-path dispatches")

    t0 = time.perf_counter()
    servers, addresses = spawn_shard_servers(manifest, read_only=True, device=CARD)
    coord = Coordinator(connect_shard_group(addresses), port=0, log=False,
                        servers=servers).start()
    log(f"coordinator over {len(servers)} spawned shard servers up in "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        with connect(coord.host, coord.port, timeout=120.0) as c:
            round_trips(c, "coordinator", f"coordinator over the {SHARD_ROWS // 1000}K shards")
        shard_fast = []
        for addr in addresses:
            host, port = addr.rsplit(":", 1)
            with connect(host, int(port), timeout=60.0) as sc:
                counters = sc.metrics()["metrics"]["counters"]
            shard_fast.append(counters.get("exec.fastpath_dispatches", 0))
    finally:
        coord.stop()
    log(f"fast-path dispatches (K4 launches) in the shard servers' own processes: "
        f"{shard_fast}; K4 launches in this process since the server: "
        f"{K.launches - launches}")
    check(all(n > 0 for n in shard_fast), "a shard server never took the fast path")
    return launches


# ------------------------------------------------------------------ slice 7

WD_TIMED = 64  # warm Wide & Deep forwards timed a shape and mode
DIST_SHARDS = 8  # the JAX test's mesh size
DIST_KEYS, DIST_KEYS_CPU = 1 << 22, 1 << 16
DIST_CAPACITY = 1 << 23
RUNNER_SECTIONS = ("dedup", "live", "shard")


def wall_ms(fn) -> tuple:
    """``fn()``'s result and its wall time in ms, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_recsys():
    """``bench.dedup_gather.run`` at its defaults on the card (the values
    equal a plain ``index_select``, the distinct count numpy's), then Wide
    & Deep at full width: ``serve_p99`` and ``serve_bulk`` batches of
    Zipf(1.3) ids, plain and with ``dedup_cap`` 1.5x the distinct ids (the
    same logits, bit for bit), ``WD_TIMED`` warm forwards a shape and mode timed; a
    retrieval over 1,000,000 candidates; the ``serve_p99`` logits and a
    slice of the retrieval scores against a CPU copy of the weights."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.bench import dedup_gather as dg_bench
    from repro_torch.configs import wide_deep
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.models.recsys import WideDeep

    for r in dg_bench.run(device=CARD, log=False):
        check(r["values_exact"], f"dedup_gather x{r['dup_factor']}: values differ from "
              "a plain index_select")
        check(r["n_unique"] == r["n_unique_numpy"], f"dedup_gather x{r['dup_factor']}: "
              f"n_unique {r['n_unique']} != numpy's {r['n_unique_numpy']}")
        log(f"dedup_gather vocab 1M dim 64 n={r['n']} dup x{r['dup_factor']}: plain "
            f"{r['t_plain_s'] * 1e3:.4f} ms, dedup {r['t_dedup_s'] * 1e3:.4f} ms (CUDA "
            f"events, best of 5); {r['n_unique']} distinct, rows fetched {r['n']} -> "
            f"{r['rows_fetched_dedup']}; values equal a plain index_select")

    # fp32 products at "highest" precision on both devices (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = wide_deep.config()
    F, V = cfg.n_sparse, cfg.vocab_per_field
    t0 = time.perf_counter()
    model = WideDeep(cfg, device=CARD, seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"Wide & Deep at full width ({F} fields x {V} vocab x {cfg.embed_dim}, MLP "
        f"{F * cfg.embed_dim + cfg.n_dense}-{'-'.join(map(str, cfg.mlp))}-1): {n_params} "
        f"parameters ({n_params * 4 / 1e9:.2f} GB fp32) made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    keep = {}
    with torch.inference_mode():
        for shape in ("serve_p99", "serve_bulk"):
            B = RECSYS_SHAPES[shape]
            zipf = (np.minimum(rng.zipf(1.3, size=(B, F, 1)), V) - 1).astype(np.int32)
            dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
            n_unique = len(np.unique(zipf + (np.arange(F, dtype=np.int32) * V)[None, :, None]))
            cap = int(n_unique * 1.5)
            sp, de = torch.from_numpy(zipf).to(CARD), torch.from_numpy(dense).to(CARD)
            modes = {"plain": cfg, "dedup": dataclasses.replace(cfg, dedup_cap=cap)}
            logits, times = {}, {}
            for mode, c in modes.items():
                model.cfg = c
                logits[mode] = model(sp, de)
                times[mode] = [wall_ms(lambda: model(sp, de))[1] for _ in range(WD_TIMED)]
            model.cfg = cfg
            check(logits["plain"].shape == (B,) and bool(torch.isfinite(logits["plain"]).all()),
                  f"Wide & Deep {shape}: logits not finite of shape ({B},)")
            check(torch.equal(logits["plain"], logits["dedup"]),
                  f"Wide & Deep {shape}: logits with dedup differ from plain (max "
                  f"{float((logits['plain'] - logits['dedup']).abs().max())})")
            log(f"Wide & Deep {shape} B={B}: {B * F} lookups a table, {n_unique} distinct "
                f"(|N|/|S| = {B * F / n_unique:.1f}x), cap {cap}; rows fetched a table "
                f"plain {B * F}, dedup {cap}; logits equal bit for bit; "
                + "; ".join(f"{m} forward p50 {pct(t, 50):.3f} ms p99 {pct(t, 99):.3f} ms"
                            for m, t in times.items())
                + f" ({WD_TIMED} warm forwards each, wall with synchronize)")
            keep[shape] = (sp, de, logits["plain"])
        n_cand = RECSYS_SHAPES["retrieval_cand"]
        gen = torch.Generator(device=CARD).manual_seed(1)
        cand = torch.randn((n_cand, cfg.mlp[-1]), generator=gen, device=CARD)
        sp1, de1 = keep["serve_p99"][0][:1], keep["serve_p99"][1][:1]
        scores = model.retrieval_scores(sp1, de1, cand)
        check(scores.shape == (1, n_cand) and bool(torch.isfinite(scores).all()),
              "retrieval_scores: not finite of shape (1, 1,000,000)")
        ms = cuda_ms(lambda _: model.retrieval_scores(sp1, de1, cand), reps=10)
        log(f"Wide & Deep retrieval over {n_cand} candidates x {cfg.mlp[-1]}: {ms:.4f} ms "
            "(CUDA events, median of 10)")
    # the CPU copy: the same weights moved off the card
    sp, de, card_logits = keep["serve_p99"]
    t0 = time.perf_counter()
    model.to("cpu")
    with torch.inference_mode():
        cpu_logits = model(sp.cpu(), de.cpu())
        cpu_scores = model.retrieval_scores(sp1.cpu(), de1.cpu(), cand[:4096].cpu())
    log(f"CPU copy of the weights and its serve_p99 forward: "
        f"{time.perf_counter() - t0:.2f} s")
    err = (cpu_logits - card_logits.cpu()).abs()
    check(torch.allclose(card_logits.cpu(), cpu_logits, rtol=1e-5, atol=1e-6),
          f"Wide & Deep serve_p99: the card's logits differ from the CPU's (max {float(err.max())})")
    check(torch.allclose(scores[:, :4096].cpu(), cpu_scores, rtol=1e-5, atol=1e-6),
          "retrieval_scores: the card's first 4096 scores differ from the CPU's")
    log(f"Wide & Deep serve_p99 on the card against the CPU copy: max |diff| "
        f"{float(err.max()):.3g} over {len(cpu_logits)} logits (rtol 1e-5, atol 1e-6); "
        f"retrieval scores of 4096 candidates within the same tolerance")
    del model, cand, keep
    torch.cuda.empty_cache()


def phase_distributed(beds):
    """The distributed PTT/PJTT with 8 shards stacked on the card: 2^22
    ``mix64`` keys (75% duplicates) in two batches, ``is_new`` against a
    numpy first-occurrence oracle; at 2^16 keys the card's tables,
    ``is_new`` and flag equal a CPU run's; the PJTT over the 1M OJM
    testbed's join, each child row's subjects against the single-device
    ``pjtt.probe_sorted``'s.  Returns the join's inputs (saved for phase
    21) and the sha256 of the rows' sorted subjects."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core import hashing, pjtt

    S = DIST_SHARDS

    def run(n, device, seed):
        ids = np.random.default_rng(seed).integers(0, n // 4, n).astype(np.int32)
        hi, lo = hashing.mix64([torch.from_numpy(ids).to(device)])
        valid = torch.ones(n, dtype=torch.bool, device=device)
        table = D.make_sharded_ptt(S, DIST_CAPACITY if n == DIST_KEYS else 4 * n, device=device)
        outs, ms = [], []
        for half in (slice(0, n // 2), slice(n // 2, n)):
            (table, is_new, ovf), t = wall_ms(lambda: D.distributed_insert(
                S, table, hi[half], lo[half], valid[half]))
            outs.append((table, is_new, ovf))
            ms.append(t)
        return hi, lo, outs, ms

    hi, lo, outs, ms = run(DIST_KEYS, CARD, 0)
    keys = (hashing.u32(hi).cpu().numpy().astype(np.uint64) << np.uint64(32)) | \
        hashing.u32(lo).cpu().numpy().astype(np.uint64)
    first = np.zeros(DIST_KEYS, bool)
    first[np.unique(keys, return_index=True)[1]] = True
    got = torch.cat([o[1] for o in outs]).cpu().numpy()
    check(not any(bool(o[2]) for o in outs), "distributed_insert overflowed at 2^22 keys")
    check(np.array_equal(got, first), "distributed_insert: is_new differs from numpy's "
          "first occurrences")
    log(f"distributed PTT, {S} shards stacked on the card, capacity {DIST_CAPACITY}: "
        f"{DIST_KEYS} keys ({int(first.sum())} distinct) in two batches: "
        f"{ms[0]:.2f} ms and {ms[1]:.2f} ms wall (the shards' inserts one after another); "
        f"is_new equals numpy's first occurrences, no overflow")

    card, cpu = run(DIST_KEYS_CPU, CARD, 1)[2], run(DIST_KEYS_CPU, "cpu", 1)[2]
    for (tc, nc, oc), (tp, np_, op) in zip(card, cpu):
        check(torch.equal(tc.hi.cpu(), tp.hi) and torch.equal(tc.lo.cpu(), tp.lo)
              and torch.equal(nc.cpu(), np_) and bool(oc) == bool(op),
              "distributed_insert: the card's tables, is_new or flag differ from the CPU's")
    log(f"distributed PTT at {DIST_KEYS_CPU} keys: tables, is_new and flags equal a CPU run's")

    tb = beds[("OJM", ROWS_PAPER)][0]
    pk, ps, ck = join_inputs(tb, CARD)
    K = ojm_shape(tb)[1]

    def pad(x):  # -1 lanes are invalid and are not sent
        return torch.cat([x, x.new_full((-len(x) % S,), -1)])

    (idx, bovf), t_build = wall_ms(lambda: D.build_distributed_pjtt(S, pad(pk), pad(ps)))
    (subs, valid, povf), t_probe = wall_ms(
        lambda: D.distributed_ojm_probe(S, idx, pad(ck), K))
    subs, valid = subs[: len(ck)], valid[: len(ck)]
    (one, t_single) = wall_ms(lambda: pjtt.probe_sorted(pjtt.build_sorted(pk, ps), ck, K))
    big = 2**31 - 1

    def rowsets(s, v):
        return torch.where(v, s, big).sort(dim=1).values

    check(not bool(bovf) and not bool(povf), "distributed PJTT: a bin or a span overflowed")
    rows = rowsets(subs, valid)
    check(torch.equal(rows, rowsets(one.subjects, one.valid)),
          "distributed PJTT: a child row's subjects differ from pjtt.probe_sorted's")
    log(f"distributed PJTT, {S} shards, 1M OJM join ({len(pk)} parent rows, {len(ck)} child "
        f"rows, K={K}): build {t_build:.2f} ms, probe {t_probe:.2f} ms wall; single-device "
        f"build+probe {t_single:.2f} ms; every row's subjects equal the single-device probe's")
    join_path = os.path.join(WORK, "ojm_join.pt")
    torch.save({"pk": pk.cpu(), "ps": ps.cpu(), "ck": ck.cpu(), "K": K}, join_path)
    return join_path, hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()


def _key_tree(x):
    return {k: _key_tree(v) for k, v in x.items()} if isinstance(x, dict) else None


def phase_runner(kernel_mods):
    """``python -m repro_torch.bench.run`` sections ``dedup``, ``live`` and
    ``shard`` at the JAX package's sizes on the card, each into a temporary
    ``--json-dir``, with the kernels' counts set to 0 just before each and
    read just after: the reports' keys equal the committed ``BENCH_live.json``
    and ``BENCH_shard.json``'s, routed queries touch one shard at 2 and 4
    shards, and the shard section launches K4.  Returns the launches."""
    import tempfile

    from repro_torch.bench import run as runner

    launches = {name: 0 for name in kernel_mods}
    with tempfile.TemporaryDirectory(dir=WORK) as out:
        for section in RUNNER_SECTIONS:
            reset(kernel_mods)
            t0 = time.perf_counter()
            runner.main(["--device", CARD, "--only", section, "--json-dir", out])
            got = counts(kernel_mods)
            log(f"runner section {section}: {time.perf_counter() - t0:.1f} s; launches {got}")
            for name, n in got.items():
                launches[name] += n
            if section == "shard":
                check(got["scan_join"] > 0, "the shard section never launched scan_join")
        for name in ("BENCH_live.json", "BENCH_shard.json"):
            with open(os.path.join(out, name)) as f:
                report = json.load(f)
            with open(os.path.join(ROOT, name)) as f:
                committed = json.load(f)
            check(_key_tree(report) == _key_tree(committed),
                  f"{name}: the report's keys differ from the committed report's")
            log(f"{name}: the keys of the committed report")
        cfg = report["classes"]["routed_single"]["configs"]
        for n in (2, 4):
            check(cfg[f"shards{n}"]["fanout_per_query"] == 1.0,
                  f"routed_single touched {cfg[f'shards{n}']['fanout_per_query']} shards "
                  f"a query at {n} shards")
    return launches


# ------------------------------------------------------------------ slice 8

TRAIN_WARM, TRAIN_TIMED = 2, 8  # full-width steps a mode: warm-up, timed
TRAIN_CUT_VOCAB, TRAIN_CUT_BATCH = 1 << 16, 4096  # the cut checks' size
TRAIN_ACCUM = 4
TRAIN_LR = 1e-3  # recsys_train_step's AdamW
# The cut checks' tolerances (measured by ``python -m
# repro_torch.bench.train_precision``: fp32 against fp64 at this cut size).
# A step's loss is a forward in fp32 (rtol 1e-5).  Its gradient is not that
# close between two orders of summation: a pre-activation that rounds to
# the other side of 0 flips a ReLU for one sample (on the CPU one flip over
# 7.3M pre-activations moved the embedding gradient by 1e-4 of its norm),
# so grad_norm gets rtol 1e-3.  AdamW then maps each gradient g to about
# lr * g / (|g| + eps): where |g| is near eps (1e-8) a tiny difference moves
# the parameter by up to lr, so params are compared in the 2-norm, leaf by
# leaf, against the update's own norm (on the CPU after two steps: up to
# 1.1% for the embedding table).
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_UPDATE_RTOL = 1e-5, 1e-3, 0.05
DEDUP_RTOL = 1e-4  # loss a step, plain against dedup on the card


def update_err(pa, pb, p0, lr: float) -> float:
    """Largest over leaves of |pa - pb| over |pb - p0| in the 2-norm (the
    update's own size); a leaf whose update ``pb - p0`` is under 1e-3 of a
    full step (lr * sqrt(size)), a gradient zero up to rounding that AdamW
    scales toward lr, counts |pa - p0| against a full step instead."""
    worst = 0.0
    for k, w0 in p0.items():
        a, b = pa[k].detach().cpu().float(), pb[k].detach().cpu().float()
        full = lr * w0.numel() ** 0.5
        moved = float((b - w0).norm())
        worst = max(worst, float((a - b).norm()) / moved if moved >= 1e-3 * full
                    else float((a - w0).norm()) / full)
    return worst


def event_adamw(marks: list, **kw):
    """The cells' AdamW (``kw``), with CUDA events recorded around each
    update into ``marks``."""
    import dataclasses

    import torch

    from repro_torch.train.optimizer import AdamW

    @dataclasses.dataclass(frozen=True)
    class EventAdamW(AdamW):
        def update(self, grads, state, params):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = super().update(grads, state, params)
            b.record()
            marks.append((a, b))
            return out

    return EventAdamW(**kw)


def run_steps(step, params, state, batches, marks: list) -> dict:
    """One step a batch, CUDA events around each step and (``marks``, from
    ``event_adamw``) each AdamW update; -> the params, state, losses, grad
    norms, and the step, forward+backward and AdamW ms of every step."""
    import torch

    marks.clear()
    spans, metrics = [], []
    for b in batches:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        params, state, m = step(params, state, *b)
        e.record()
        spans.append((s, e))
        metrics.append(m)
    torch.cuda.synchronize()
    return dict(params=params, state=state,
                losses=[float(m["loss"]) for m in metrics],
                norms=[float(m["grad_norm"]) for m in metrics],
                step_ms=[s.elapsed_time(e) for s, e in spans],
                fb_ms=[s.elapsed_time(a) for (s, _), (a, _) in zip(spans, marks)],
                adam_ms=[a.elapsed_time(b) for a, b in marks])


def phase_training(kernel_mods):
    """Wide & Deep training through ``configs.cells.recsys_train_step`` (the
    JAX cell's ``AdamW(lr=1e-3)`` and ``make_train_step``) on the card.  At
    full width (40 x 2^20 x 32, batch ``train_batch``), plain and with
    ``dedup_cap`` 1.5x the most distinct ids of a batch, from the same seeded
    weights on the same Zipf(1.3) batches: 2 warm-up and 8 timed steps each,
    forward+backward and the AdamW update timed apart by CUDA events, the
    peak memory, and every loss (finite, falling; plain and dedup within
    ``DEDUP_RTOL`` a step), the kernels' counts set to 0 just before and read
    just after.  At a cut size (vocab 2^16 a field, batch 4,096): two steps
    against a CPU copy of the weights; ``grad_accum`` 4 against 1 on one
    batch; a ``compress=True`` step; a checkpoint round trip through a
    ``RetryPolicy`` step that fails once, which must reach an uninterrupted
    run's params.  Returns the launches of the full-width runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import cells, wide_deep
    from repro_torch.configs.registry import RECSYS_SHAPES, get_arch
    from repro_torch.models.recsys import WideDeep
    from repro_torch.train import checkpoint, fault
    from repro_torch.train.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = wide_deep.config()
    F, V = cfg.n_sparse, cfg.vocab_per_field
    B = RECSYS_SHAPES[get_arch("wide-deep").train_shape]
    rng = np.random.default_rng(3)
    w_true = rng.normal(size=cfg.n_dense).astype(np.float32)

    def batch(b, vocab, device):
        """Zipf(1.3) ids and the example's labels ``dense @ w_true + 0.3 *
        noise > 0``, on ``device``."""
        sp = (np.minimum(rng.zipf(1.3, size=(b, F, 1)), vocab) - 1).astype(np.int32)
        de = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
        y = (de @ w_true + 0.3 * rng.normal(size=b) > 0).astype(np.int32)
        return tuple(torch.from_numpy(a).to(device) for a in (sp, de, y))

    n_steps = TRAIN_WARM + TRAIN_TIMED
    t0 = time.perf_counter()
    batches = [batch(B, V, CARD) for _ in range(n_steps)]
    offs = torch.arange(F, device=CARD, dtype=torch.int32)[None, :, None] * V
    distinct = [int(torch.unique(b[0] + offs).numel()) for b in batches]
    cap = int(max(distinct) * 1.5)
    log(f"training batches: {n_steps} of {B} rows, {B * F} lookups a table each, "
        f"{min(distinct)}-{max(distinct)} distinct (|N|/|S| = {B * F / max(distinct):.1f}-"
        f"{B * F / min(distinct):.1f}x); dedup cap {cap}: rows fetched a table and step "
        f"plain {B * F}, dedup {cap} ({time.perf_counter() - t0:.2f} s to draw)")

    def train(c):
        """``n_steps`` steps of a fresh seed-0 model under ``c``; -> (losses,
        grad norms, step ms, forward+backward ms, AdamW ms, peak bytes)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = WideDeep(c, device=CARD, seed=0)
        marks = []
        step, opt, params = cells.recsys_train_step(c, model, event_adamw(marks, lr=1e-3))
        check(dataclasses.asdict(opt) == dataclasses.asdict(AdamW(lr=1e-3)),
              "the timed optimizer is not the cell's AdamW(lr=1e-3)")
        r = run_steps(step, params, opt.init(params), batches, marks)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in params.values())
        del model, step, params, r["params"], r["state"]
        torch.cuda.empty_cache()
        return (r["losses"], r["norms"], r["step_ms"], r["fb_ms"], r["adam_ms"], peak,
                n_params)

    reset(kernel_mods)
    runs = {"plain": train(cfg), "dedup": train(dataclasses.replace(cfg, dedup_cap=cap))}
    launches = counts(kernel_mods)
    for mode, (losses, norms, step_ms, fb_ms, adam_ms, peak, n_params) in runs.items():
        timed_steps = slice(TRAIN_WARM, None)
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"training {mode}: a loss or grad_norm is not finite: {losses} {norms}")
        check(losses[-1] < losses[0], f"training {mode}: the loss did not fall: {losses}")
        log(f"Wide & Deep training at full width ({n_params} parameters, batch {B}), {mode}: "
            f"step p50 {pct(step_ms[timed_steps], 50):.3f} ms p99 "
            f"{pct(step_ms[timed_steps], 99):.3f} ms; forward+backward p50 "
            f"{pct(fb_ms[timed_steps], 50):.3f} ms; AdamW update p50 "
            f"{pct(adam_ms[timed_steps], 50):.3f} ms p99 {pct(adam_ms[timed_steps], 99):.3f} ms "
            f"(CUDA events, {TRAIN_TIMED} steps after {TRAIN_WARM} warm-up); peak memory "
            f"{peak / 1e9:.3f} GB (max_memory_allocated); first steps' ms "
            f"{[round(x, 3) for x in step_ms[:TRAIN_WARM]]}")
        log(f"  {mode} losses {[round(x, 6) for x in losses]}; grad norms "
            f"{[round(x, 6) for x in norms]}")
    lp, ld = np.array(runs["plain"][0]), np.array(runs["dedup"][0])
    err = float(np.max(np.abs(lp - ld) / np.abs(lp)))
    check(err <= DEDUP_RTOL, f"training: dedup losses differ from plain by {err:.3g} "
          f"relative (> {DEDUP_RTOL})")
    log(f"training: plain and dedup losses agree within {err:.3g} relative a step (rtol "
        f"{DEDUP_RTOL}; the card's scatter-add sums in a varying order); launches of "
        f"K1-K4 over both runs {launches}")
    del batches

    # ---- the cut size: vocab 2^16 a field, batch 4,096
    cut = dataclasses.replace(cfg, vocab_per_field=TRAIN_CUT_VOCAB)
    Bc = TRAIN_CUT_BATCH
    small = [batch(Bc, TRAIN_CUT_VOCAB, "cpu") for _ in range(4)]
    log(f"cut size for the checks below: vocab {TRAIN_CUT_VOCAB} a field (full: {V}), batch "
        f"{Bc} (full: {B}); every width else as above")

    def fresh(device=CARD, **kw):
        model = WideDeep(cut, device=CARD, seed=1).to(device)
        return cells.recsys_train_step(cut, model, **kw)

    p0 = {k: v.detach().cpu().clone() for k, v in fresh()[2].items()}

    t0 = time.perf_counter()
    res = {}
    for dev in (CARD, "cpu"):
        step, opt, params = fresh(dev)
        state = opt.init(params)
        ms = []
        for b in small[:2]:
            params, state, m = step(params, state, *(x.to(dev) for x in b))
            ms.append([float(m["loss"]), float(m["grad_norm"])])
        res[dev] = (np.array(ms), params)
    (mc, pc), (mh, ph) = res[CARD], res["cpu"]
    l_err, g_err = (float(np.max(np.abs(mc[:, i] - mh[:, i]) / np.abs(mh[:, i])))
                    for i in (0, 1))
    p_err = update_err(pc, ph, p0, TRAIN_LR)
    check(l_err <= TRAIN_LOSS_RTOL and g_err <= TRAIN_GNORM_RTOL and p_err <= TRAIN_UPDATE_RTOL,
          f"training: the card's first two steps differ from the CPU's (loss {l_err:.3g}, "
          f"grad_norm {g_err:.3g} relative; params {p_err:.3g} of the update)")
    log(f"training at the cut size, two steps on the card against a CPU copy of the "
        f"weights: loss within {l_err:.3g} (rtol {TRAIN_LOSS_RTOL}), grad_norm within "
        f"{g_err:.3g} (rtol {TRAIN_GNORM_RTOL}), params within {p_err:.3g} of the update's "
        f"norm (rtol {TRAIN_UPDATE_RTOL}); largest |diff| of a parameter "
        f"{max(float((pc[k].detach().cpu() - ph[k].detach()).abs().max()) for k in p0):.3g} "
        f"({time.perf_counter() - t0:.2f} s)")
    del res, pc, ph

    sp, de, y = (x.to(CARD) for x in small[0])
    step1, opt, p1 = fresh()
    p1, _, m1 = step1(p1, opt.init(p1), sp, de, y)
    step4, opt, p4 = fresh(grad_accum=TRAIN_ACCUM)
    micro = [x.reshape(TRAIN_ACCUM, Bc // TRAIN_ACCUM, *x.shape[1:]) for x in (sp, de, y)]
    p4, _, m4 = step4(p4, opt.init(p4), *micro)
    a_err = abs(float(m4["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    ag_err = abs(float(m4["grad_norm"]) - float(m1["grad_norm"])) / float(m1["grad_norm"])
    ap_err = update_err(p4, p1, p0, TRAIN_LR)
    check(a_err <= TRAIN_LOSS_RTOL and ag_err <= TRAIN_GNORM_RTOL
          and ap_err <= TRAIN_UPDATE_RTOL,
          f"training: grad_accum {TRAIN_ACCUM} differs from 1 (loss {a_err:.3g}, grad_norm "
          f"{ag_err:.3g} relative, params {ap_err:.3g} of the update)")
    stepc, opt, pcmp = fresh(compress=True)
    pcmp, _, mcmp, efb = stepc(pcmp, opt.init(pcmp), sp, de, y)
    c_err = update_err(pcmp, p1, p0, TRAIN_LR)
    check(bool(torch.isfinite(mcmp["loss"])) and c_err > 0
          and all(bool(torch.isfinite(e).all()) for e in efb.values()),
          "training: the compress=True step gave a non-finite loss or error, or the plain "
          "step's params")
    log(f"grad_accum {TRAIN_ACCUM} against 1 on one batch: loss within {a_err:.3g}, grad_norm "
        f"within {ag_err:.3g}, params within {ap_err:.3g} of the update; a compress=True step "
        f"ran (loss {float(mcmp['loss']):.6f}; its params {c_err:.3g} of the update's norm "
        f"from the plain step's: gradients under 1/254 of a leaf's largest round to 0)")
    del p1, p4, pcmp, efb

    # a checkpoint round trip: save after 2 steps, a step that fails once after
    # its update has written the params, restore, retry, one more step
    t0 = time.perf_counter()
    cuts = [tuple(x.to(CARD) for x in b) for b in small]
    step, opt, ref = fresh()
    state = opt.init(ref)
    for b in cuts:
        ref, state, _ = step(ref, state, *b)
    step, opt, params = fresh()
    live = {"state": opt.init(params), "failed": 0}
    root = os.path.join(WORK, "checkpoints")
    for b in cuts[:2]:
        params, live["state"], _ = step(params, live["state"], *b)
    checkpoint.save(os.path.join(root, "step_2"), (params, live["state"]), step=2)

    def flaky():
        out = step(params, live["state"], *cuts[2])
        if not live["failed"]:
            live["failed"] += 1
            raise RuntimeError("simulated failure after the update")
        return out

    def on_failure(attempt, exc):
        (rp, rs), n = checkpoint.restore(checkpoint.latest_step_dir(root),
                                         (params, live["state"]), device=CARD)
        check(n == 2, f"restored step {n}, not 2")
        with torch.no_grad():
            for k, v in rp.items():
                params[k].copy_(v)
        live["state"] = rs

    _, live["state"], _ = fault.RetryPolicy(max_retries=2, backoff_s=0.0).run(
        flaky, on_failure=on_failure)
    params, live["state"], _ = step(params, live["state"], *cuts[3])
    r_err = update_err(params, ref, p0, TRAIN_LR)
    check(live["failed"] == 1 and int(live["state"].step) == 4 and r_err <= TRAIN_UPDATE_RTOL,
          f"training: the restored run's params differ from the uninterrupted run's by "
          f"{r_err:.3g} of the update (step {int(live['state'].step)})")
    log(f"checkpoint round trip (save at step 2, a failed step 3, restore, retry, step 4): "
        f"params within {r_err:.3g} of the update's norm of an uninterrupted run (rtol "
        f"{TRAIN_UPDATE_RTOL}; the card's scatter-add sums in a varying order) "
        f"({time.perf_counter() - t0:.2f} s)")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches



# ------------------------------------------------------------------ slice 9

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 peak (NVIDIA's data sheet)
LM_WARM, LM_TIMED = 2, 16  # decode steps a cell: warm-up, timed
# qwen's requests through serve_lm; prompt 512 until phase 21 needed the time (the
# cache check fills the cache with one decode step a prompt position)
LM_SERVE = dict(batch=4, prompt=128, gen=64)
QWEN_DECODE_BATCH = 32  # decode_32k's batch, cut from 128: params + cache 45.4 GB
MIXTRAL_LAYERS = 8  # cut from 32: 32 layers in bf16 are 93 GB, 8 are 23.7 GB
PREFILL_BATCH, PREFILL_WARM_SEQ = 1, 4096  # prefill_32k's batch, cut from 32
LM_PARITY_LAYERS = {"qwen2.5-3b": 2, "mixtral-8x7b": 1}  # the fp32 CPU checks' depth
LM_PARITY_SEQ, LM_PARITY_CHUNK, LM_PARITY_BATCH, LM_PARITY_STEPS = 256, 64, 2, 8
LM_PARITY_TOL = 1e-4  # ||card - cpu||_inf / ||cpu||_inf, fp32 without TF32


def lm_costs(cfg, q_tokens: int, pairs: int, logits_rows: int, experts: int | None = None):
    """(weight bytes, operations) one LM call needs: every weight read once
    (an MoE layer's ``experts`` of its experts, all by default; the
    embedding only its ``q_tokens`` rows), and 2 operations a multiply-add:
    the layers' matmuls for ``q_tokens`` tokens (top_k experts each), the
    attention's two products over ``pairs`` (query, key) pairs, and the
    logits of ``logits_rows`` rows."""
    import torch

    it = torch.finfo(cfg.dtype).bits // 8
    d, D, H, K, f, L = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv, cfg.d_ff,
                        cfg.n_layers)
    attn = d * (H + 2 * K) * D + H * D * d + (H + 2 * K) * D * cfg.qkv_bias
    if cfg.moe:
        ffn_w, ffn_tok, router = 3 * d * f * (experts or cfg.n_experts), 3 * d * f * cfg.top_k, \
            d * cfg.n_experts
    else:
        ffn_w = ffn_tok = 3 * d * f
        router = 0
    head = cfg.vocab * d
    weight_bytes = (it * (L * (attn + ffn_w + 2 * d) + d + head + q_tokens * d)
                    + 4 * L * router)
    ops = (2 * q_tokens * L * (attn + ffn_tok + router) + 4 * L * H * D * pairs
           + 2 * logits_rows * head)
    return weight_bytes, ops


def bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def causal_pairs(batch: int, seq: int, window) -> int:
    """(query, key) pairs a causal prefill attends: min(i + 1, window) a query."""
    w = min(window or seq, seq)
    return batch * (w * (w + 1) // 2 + (seq - w) * w)


class Sections:
    """CUDA events around the LM's attention, cache write, MoE routing and
    MoE dispatch+experts functions while it is entered (each module
    attribute wrapped, restored on exit): the stream time of each section
    over the calls, in ms, after a synchronize."""

    def __init__(self):
        from repro_torch.models import attention, moe

        self.targets = [(attention, "_sdpa", "attention"),
                        (attention, "_chunked_sdpa", "attention"),
                        (attention, "write_cache", "cache write"),
                        (moe, "_route", "MoE routing"),
                        (moe, "_dispatch_compute_combine", "MoE dispatch+experts")]
        self.marks = []

    def __enter__(self):
        import torch

        self.saved = []
        for mod, name, label in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **k):
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                out = _fn(*a, **k)
                e.record()
                self.marks.append((_label, s, e))
                return out

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {}
        for label, s, e in self.marks:
            out[label] = out.get(label, 0.0) + s.elapsed_time(e)
        return out


KERNEL_KINDS = (("gemm", ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")),
                ("softmax", ("softmax",)), ("copy", ("copy",)),
                ("index/scatter/gather", ("index", "scatter", "gather")),
                ("sort/search", ("sort", "radix", "search", "cub::")),
                ("reduce", ("reduce",)))


def lm_profile(label: str, fn) -> None:
    """Log ``fn()``'s stages twice: its sections' stream time by CUDA events
    (``Sections``), and its kernels' device time by kind of kernel name
    from ``torch.profiler`` (the rest elementwise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with Sections() as sec:
        s.record()
        fn()
        e.record()
    parts = sec.ms()  # synchronizes
    total = s.elapsed_time(e)
    rest = total - sum(parts.values())
    log(f"  {label} by section (CUDA events, one call, {total:.3f} ms): "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in parts.items())
        + f", the rest (embedding, norms, rope, projections, FFN, logits) {rest:.3f} ms "
        f"({100 * rest / total:.1f}%)")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [(ev.name, ev.time_range.elapsed_us() / 1e3) for ev in prof.events()
                   if str(ev.device_type).endswith("CUDA")]
    except Exception as exc:  # a measurement the card could not give
        log(f"  {label}: torch.profiler failed ({type(exc).__name__}: {exc}); kernels not "
            "measured")
        return
    if not kernels:
        log(f"  {label}: torch.profiler recorded no kernel; kernels not measured")
        return
    kinds, top = {}, {}
    for name, ms in kernels:
        low = name.lower()
        kind = next((k for k, keys in KERNEL_KINDS if any(x in low for x in keys)),
                    "elementwise/other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        top[name] = top.get(name, 0.0) + ms
    busy = sum(kinds.values())
    log(f"  {label} by kernel kind (torch.profiler, {len(kernels)} kernels, {busy:.3f} ms "
        "busy): " + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
                              for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:9.3f} ms  {name[:150]}")


def fill_cache(cache, first_pos: int, gen) -> None:
    """Seeded k and v; slot j holds position ``first_pos + j`` (the slot
    order ``pos % T`` of a ring, as ``first_pos`` is a multiple of T)."""
    import torch

    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    t = cache.pos.shape[-1]
    cache.pos.copy_(torch.arange(first_pos, first_pos + t, dtype=torch.int32,
                                 device=cache.pos.device).expand_as(cache.pos))


def time_prefill(cfg, params, seq: int, rng) -> dict:
    """One warm-up prefill at ``PREFILL_WARM_SEQ``, then one timed at
    ``seq`` (CUDA events), batch ``PREFILL_BATCH``: ms, peak GB, its bound."""
    import torch

    from repro_torch.models import transformer

    dev = torch.device(CARD)
    with torch.inference_mode():
        warm = torch.from_numpy(rng.integers(0, cfg.vocab, size=(PREFILL_BATCH,
                                                                 PREFILL_WARM_SEQ))).to(dev)
        transformer.prefill(cfg, params, warm)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(PREFILL_BATCH, seq))).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        logits = transformer.prefill(cfg, params, toks)
        e.record()
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (PREFILL_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill at {seq}: logits not finite of shape (1, 1, {cfg.vocab})")
    nbytes, ops = lm_costs(cfg, PREFILL_BATCH * seq, causal_pairs(PREFILL_BATCH, seq, cfg.window),
                           PREFILL_BATCH)
    b_ms, b_by = bound_ms(nbytes, ops)
    return dict(ms=s.elapsed_time(e), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                bound_ms=b_ms, bound_by=b_by, ops=ops)


def time_decode(cfg, params, cache, batch: int, position: int, rng) -> dict:
    """``LM_WARM`` + ``LM_TIMED`` decode steps at ``position`` (each rewrites
    that slot), CUDA events a step; p50/p99 of the timed, peak GB, bound."""
    import torch

    from repro_torch.models import transformer

    dev = torch.device(CARD)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(batch, 1))).to(dev)
    pos = torch.tensor(position, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    with torch.inference_mode():
        for _ in range(LM_WARM + LM_TIMED):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            logits, _ = transformer.decode_step(cfg, params, cache, tok, pos)
            e.record()
            marks.append((s, e))
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (batch, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{cfg.name} decode at {position}: logits not finite of shape ({batch}, 1, "
          f"{cfg.vocab})")
    ms = [s.elapsed_time(e) for s, e in marks[LM_WARM:]]
    T = cache.k.shape[2]
    visible = min(T, cfg.window or T, position + 1)
    nbytes, ops = lm_costs(cfg, batch, batch * visible, batch)
    it = cache.k.element_size()
    cache_bytes = (2 * cache.k.numel() * it + cache.pos.numel() * 4
                   + 2 * cfg.n_layers * batch * cfg.n_kv * cfg.head_dim * it)
    b_ms, b_by = bound_ms(nbytes + cache_bytes, ops)
    return dict(p50=pct(ms, 50), p99=pct(ms, 99), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                bound_ms=b_ms, bound_by=b_by, weight_gb=nbytes / 1e9, cache_gb=cache_bytes / 1e9)


def lm_parity(arch: str, layers: int) -> dict:
    """``arch`` at its published widths and ``layers`` layers in fp32, the
    same seeded weights on the card and on the CPU: a prefill of 1 x 256 on
    the chunked path (``attn_chunk`` 64), then 8 decode steps at batch 2
    from an empty cache; every logits tensor within ``LM_PARITY_TOL`` of its
    largest magnitude, and an MoE's routing equal call by call (a token
    routed apart fails the check with its index and the CPU's margin
    between the k-th and the next probability)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import nest

    cfg = dataclasses.replace(registry.get_arch(arch).config(), n_layers=layers,
                              dtype=torch.float32, attn_chunk=LM_PARITY_CHUNK)
    model = transformer.Transformer(cfg, device=CARD, seed=1)
    on = {CARD: model.params(),
          "cpu": nest({k: v.detach().cpu() for k, v in model.named_parameters()})}
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, LM_PARITY_SEQ)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, size=(LM_PARITY_BATCH, LM_PARITY_STEPS)))
    route = moe._route
    out = {}
    for dev, params in on.items():
        routes, logits = [], []

        def recording(p, c, xt, _routes=routes):
            vals, idx, aux = route(p, c, xt)
            probs = torch.softmax(xt.to(torch.float32) @ p["router"]["w"], dim=-1)
            top = torch.sort(probs, dim=-1, descending=True, stable=True).values
            _routes.append((idx.cpu(), (top[:, c.top_k - 1] - top[:, c.top_k]).cpu()))
            return vals, idx, aux

        moe._route = recording
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                logits.append(transformer.prefill(cfg, params, prompt.to(dev)).cpu())
                cache = transformer.make_cache(cfg, LM_PARITY_BATCH, LM_PARITY_STEPS, dev)
                for i in range(LM_PARITY_STEPS):
                    lg, cache = transformer.decode_step(
                        cfg, params, cache, steps[:, i:i + 1].to(dev),
                        torch.tensor(i, dtype=torch.int32, device=dev))
                    logits.append(lg.cpu())
        finally:
            moe._route = route
        out[dev] = (logits, routes, time.perf_counter() - t0)
    (lc, rc, tc), (lh, rh, th) = out[CARD], out["cpu"]
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(lc, lh, strict=True)]
    check(all(np.isfinite(errs)) and max(errs) <= LM_PARITY_TOL,
          f"{arch} ({layers} layers, fp32): the card's logits differ from the CPU's by "
          f"{max(errs):.3g} of their largest (> {LM_PARITY_TOL}): {errs}")
    margin = None
    if cfg.moe:
        check(len(rc) == len(rh), f"{arch}: {len(rc)} routing calls on the card, {len(rh)} "
              "on the CPU")
        for call, ((ic, _), (ih, mh)) in enumerate(zip(rc, rh)):
            bad = (ic != ih).any(dim=-1).nonzero().flatten().tolist()
            check(not bad, f"{arch}: routing call {call} sends token {bad[:1]} to experts "
                  f"{ic[bad[:1]].tolist()} on the card and {ih[bad[:1]].tolist()} on the CPU "
                  f"(the CPU's margin between its k-th and next probability "
                  f"{float(mh[bad[0]]) if bad else 0:.3g})")
        margin = min(float(m.min()) for _, m in rh)
    del model, on
    torch.cuda.empty_cache()
    return dict(errs=errs, card_s=tc, cpu_s=th, routing_calls=len(rh), min_margin=margin,
                params=cfg.param_count())


def phase_lm(kernel_mods):
    """The LM family on the card at its published widths (bf16): qwen2.5-3b
    at full depth serves ``LM_SERVE`` requests through
    ``examples/serve_lm.py`` (prefill, the cache filled by ``decode_step``
    and held to the prefill's logits, greedy decode), then
    ``prefill_32k`` at batch ``PREFILL_BATCH`` (chunked, ``attn_chunk``
    1024) and ``decode_32k`` at batch ``QWEN_DECODE_BATCH`` over a seeded
    32,768-slot cache; mixtral-8x7b at ``MIXTRAL_LAYERS`` layers:
    ``decode_32k`` at batch 128 and ``long_500k`` at batch 1 over the
    4,096-slot ring, and ``prefill_32k`` at batch 1.  Each against its
    bound; the stages of a decode step and a prefill (sections by CUDA
    events, kernels by ``torch.profiler``); the decode attention's
    ``einsum`` over one layer's cache, its memory and time; and in fp32 at
    full width and cut depth, the card against the CPU (``lm_parity``).
    No K1-K4 launch (their counts set to 0 before and read after)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.registry import LM_DECODE, LM_LONG, LM_PREFILL
    from repro_torch.examples import serve_lm
    from repro_torch.models import attention, moe, transformer

    reset(kernel_mods)
    dev = torch.device(CARD)
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=CARD).manual_seed(17)

    # ---- (a) qwen2.5-3b, full width and depth: a few requests through serve_lm
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    res = serve_lm.main(["--device", CARD, "--arch", "qwen2.5-3b", "--size", "full",
                         "--batch", str(LM_SERVE["batch"]), "--prompt-len",
                         str(LM_SERVE["prompt"]), "--gen", str(LM_SERVE["gen"])])
    qcfg = res["cfg"]
    check(res["checked"] and res["finite"]
          and tuple(res["tokens"].shape) == (LM_SERVE["batch"], LM_SERVE["gen"])
          and bool(((res["tokens"] >= 0) & (res["tokens"] < qcfg.vocab)).all()),
          "qwen serve_lm: tokens out of range or logits not finite")
    B, S, G = LM_SERVE["batch"], LM_SERVE["prompt"], LM_SERVE["gen"]
    pf_ms = bound_ms(*lm_costs(qcfg, B * S, causal_pairs(B, S, None), B))
    w_bytes, d_ops = lm_costs(qcfg, B, B * (S + G), B)
    it = torch.finfo(qcfg.dtype).bits // 8
    cache_bytes = qcfg.n_layers * B * (S + G) * (2 * qcfg.n_kv * qcfg.head_dim * it + 4)
    dc_ms = bound_ms(w_bytes + cache_bytes, d_ops)
    log(f"qwen2.5-3b serve_lm at full width ({qcfg.param_count()} parameters, bf16, "
        f"{qcfg.n_layers} layers): batch {B}, prompt {S}, gen {G}: prefill "
        f"{res['prefill_s'] * 1e3:.3f} ms ({res['prefill_tok_s']:.1f} tokens/s; bound "
        f"{pf_ms[0]:.3f} ms by {pf_ms[1]}), decode {res['decode_ms_step']:.3f} ms a step "
        f"({res['decode_tok_s']:.1f} tokens/s; bound {dc_ms[0]:.3f} ms by {dc_ms[1]}, the "
        f"whole {S + G}-slot cache read; host clock with synchronize); the cache path "
        f"filled over the prompt ({res['fill_s']:.2f} s) against the prefill: "
        f"{res['logits_err']:.3g} of the logits' largest (tolerance "
        f"{serve_lm.TOL[qcfg.dtype]}); peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
        f"({time.perf_counter() - t0:.1f} s)")
    del res
    torch.cuda.empty_cache()

    # ---- (b) qwen prefill_32k at batch 1, (c) decode_32k at batch 32
    t0 = time.perf_counter()
    model = transformer.Transformer(qcfg, device=CARD, seed=0)
    params = model.params()
    seq, ctx = LM_PREFILL["seq"], LM_DECODE["ctx"]
    pf = time_prefill(qcfg, params, seq, rng)
    log(f"qwen2.5-3b prefill_32k (batch {PREFILL_BATCH}, cut from {LM_PREFILL['batch']}; "
        f"chunked, attn_chunk {qcfg.attn_chunk}): {pf['ms']:.3f} ms (CUDA events, one pass "
        f"after a warm-up at {PREFILL_WARM_SEQ}), {PREFILL_BATCH * seq / pf['ms'] * 1e3:.1f} "
        f"tokens/s; bound {pf['bound_ms']:.3f} ms by {pf['bound_by']} ({pf['ops'] / 1e12:.1f} "
        f"TFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16); {pf['bound_ms'] / pf['ms']:.3f} "
        f"of it; peak {pf['peak_gb']:.3f} GB")
    with torch.inference_mode():
        lm_profile(f"qwen2.5-3b prefill at {PREFILL_WARM_SEQ}", lambda: transformer.prefill(
            qcfg, params, torch.from_numpy(rng.integers(0, qcfg.vocab, size=(
                1, PREFILL_WARM_SEQ))).to(dev)))
    B = QWEN_DECODE_BATCH
    cache = transformer.make_cache(qcfg, B, ctx, dev)
    fill_cache(cache, 0, gen)
    dc = time_decode(qcfg, params, cache, B, ctx - 1, rng)
    log(f"qwen2.5-3b decode_32k (batch {B}, cut from {LM_DECODE['batch']}; ctx {ctx}, every "
        f"step at position {ctx - 1}): p50 {dc['p50']:.3f} ms p99 {dc['p99']:.3f} ms a step "
        f"(CUDA events, {LM_TIMED} after {LM_WARM} warm-up), {B / dc['p50'] * 1e3:.1f} "
        f"tokens/s; bound {dc['bound_ms']:.3f} ms by {dc['bound_by']} (weights "
        f"{dc['weight_gb']:.3f} GB + cache {dc['cache_gb']:.3f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {dc['bound_ms'] / dc['p50']:.3f} of it; peak "
        f"{dc['peak_gb']:.3f} GB")
    pos = torch.tensor(ctx - 1, dtype=torch.int32, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        lm_profile(f"qwen2.5-3b decode step at batch {B}, ctx {ctx}",
                   lambda: transformer.decode_step(qcfg, params, cache, tok, pos))
        # does the decode attention's einsum copy a layer's cache?
        k, v = cache.k[0], cache.v[0]
        q = torch.randn((B, 1, qcfg.n_heads, qcfg.head_dim), generator=gen, device=dev,
                        dtype=qcfg.dtype)
        q5 = q.reshape(B, 1, qcfg.n_kv, qcfg.n_heads // qcfg.n_kv, qcfg.head_dim)
        mask = (cache.pos[0] >= 0)[:, None, :]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        scores = torch.einsum("bshgd,bthd->bhgst", q5, k)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - scores.numel() * scores.element_size()
        sd_ms = cuda_ms(lambda _: attention._sdpa(q, k, v, mask, 1.0 / np.sqrt(qcfg.head_dim)),
                        reps=5, warmup=1)
    k_bytes = k.numel() * k.element_size()
    log(f"  decode attention over one layer's cache ((B, T, n_kv, D) = {tuple(k.shape)}, k "
        f"and v {k_bytes / 1e9:.3f} GB each): `_sdpa` {sd_ms:.3f} ms (CUDA events, median of "
        f"5) against {2 * k_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms to read k and v once; the "
        f"scores' einsum allocates {extra / 1e9:.3f} GB beyond its inputs and output: "
        + ("a contiguous copy of k (the probabilities' einsum copies v alike), each step and "
           "layer" if extra >= 0.9 * k_bytes else "no copy of k"))
    del model, params, cache, k, v, q, q5, mask, scores
    torch.cuda.empty_cache()
    log(f"  qwen2.5-3b cells took {time.perf_counter() - t0:.1f} s")

    # ---- mixtral-8x7b, full width, MIXTRAL_LAYERS layers
    t0 = time.perf_counter()
    mcfg = dataclasses.replace(registry.get_arch("mixtral-8x7b").config(),
                               n_layers=MIXTRAL_LAYERS)
    model = transformer.Transformer(mcfg, device=CARD, seed=0)
    params = model.params()
    log(f"mixtral-8x7b at full width, {MIXTRAL_LAYERS} of "
        f"{registry.get_arch('mixtral-8x7b').config().n_layers} layers: "
        f"{sum(p.numel() for p in model.parameters())} parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.3f} GB bf16) "
        f"made in {time.perf_counter() - t0:.2f} s")
    W = mcfg.window
    for cell, B, ctx in (("decode_32k", LM_DECODE["batch"], LM_DECODE["ctx"]),
                         ("long_500k", LM_LONG["batch"], LM_LONG["ctx"])):
        cache = transformer.make_cache(mcfg, B, ctx, dev)
        fill_cache(cache, ctx - W, gen)
        dc = time_decode(mcfg, params, cache, B, ctx - 1, rng)
        need = min(mcfg.n_experts, B * mcfg.top_k)
        w_need = lm_costs(mcfg, B, B * W, B, experts=need)[0]
        log(f"mixtral-8x7b {cell} (batch {B}, ctx {ctx}, a {cache.k.shape[2]}-slot ring "
            f"holding positions {ctx - W}-{ctx - 1}): p50 {dc['p50']:.3f} ms p99 "
            f"{dc['p99']:.3f} ms a step (CUDA events, {LM_TIMED} after {LM_WARM} warm-up), "
            f"{B / dc['p50'] * 1e3:.1f} tokens/s; bound {dc['bound_ms']:.3f} ms by "
            f"{dc['bound_by']} (weights {dc['weight_gb']:.3f} GB with every expert + cache "
            f"{dc['cache_gb']:.3f} GB), {dc['bound_ms'] / dc['p50']:.3f} of it; with the "
            f"{need} experts a layer its tokens can reach, weights {w_need / 1e9:.3f} GB, "
            f"bound {(w_need + dc['cache_gb'] * 1e9) / HBM_BYTES_PER_S * 1e3:.3f} ms; peak "
            f"{dc['peak_gb']:.3f} GB")
        if cell == "decode_32k":
            pos = torch.tensor(ctx - 1, dtype=torch.int32, device=dev)
            tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            with torch.inference_mode():
                lm_profile(f"mixtral-8x7b decode step at batch {B}",
                           lambda: transformer.decode_step(mcfg, params, cache, tok, pos))
        del cache
        torch.cuda.empty_cache()
    seq = LM_PREFILL["seq"]
    pf = time_prefill(mcfg, params, seq, rng)
    log(f"mixtral-8x7b prefill_32k (batch {PREFILL_BATCH}, cut from {LM_PREFILL['batch']}; "
        f"chunked, window {W}, every chunk computed; MoE cap "
        f"{moe.capacity(mcfg.moe_cfg, seq)}): {pf['ms']:.3f} ms (CUDA events, one pass after "
        f"a warm-up at {PREFILL_WARM_SEQ}), {seq / pf['ms'] * 1e3:.1f} tokens/s; bound "
        f"{pf['bound_ms']:.3f} ms by {pf['bound_by']} ({pf['ops'] / 1e12:.1f} TFLOP), "
        f"{pf['bound_ms'] / pf['ms']:.3f} of it; peak {pf['peak_gb']:.3f} GB")
    with torch.inference_mode():
        lm_profile(f"mixtral-8x7b prefill at {PREFILL_WARM_SEQ}", lambda: transformer.prefill(
            mcfg, params, torch.from_numpy(rng.integers(0, mcfg.vocab, size=(
                1, PREFILL_WARM_SEQ))).to(dev)))
    del model, params
    torch.cuda.empty_cache()
    log(f"  mixtral-8x7b cells took {time.perf_counter() - t0:.1f} s")

    # ---- fp32 at full width and cut depth: the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for arch, layers in LM_PARITY_LAYERS.items():
        r = lm_parity(arch, layers)
        log(f"{arch} at full width, {layers} layer(s), fp32 ({r['params']} parameters): "
            f"prefill 1 x {LM_PARITY_SEQ} (chunked, attn_chunk {LM_PARITY_CHUNK}) and "
            f"{LM_PARITY_STEPS} decode steps at batch {LM_PARITY_BATCH}, card against CPU: "
            f"largest {max(r['errs']):.3g} of the logits' largest (tolerance "
            f"{LM_PARITY_TOL}; prefill {r['errs'][0]:.3g})"
            + (f"; routing equal over {r['routing_calls']} calls (the CPU's smallest margin "
               f"between a token's k-th and next probability {r['min_margin']:.3g})"
               if r["min_margin"] is not None else "")
            + f" (card {r['card_s']:.2f} s, CPU {r['cpu_s']:.2f} s)")
    launches = counts(kernel_mods)
    check(not any(launches.values()), f"the LM phase launched K1-K4: {launches}")
    log(f"launches of K1-K4 in the LM phase: {launches}")


# ------------------------------------------------------------------ slice 10

FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (TF32 is off here)
LM_TRAIN_BATCH = 3  # train_4k's batch, cut from 256: the most sequences that fit with remat
LM_TRAIN_WARM, LM_TRAIN_TIMED = 1, 2  # 4 timed steps until phase 21 needed the time
LM_TRAIN_IDS = 4096  # tokens drawn from the first 4,096 ids: a unigram the step can learn
REMAT_DEPTHS = (2, 4)  # remat off against on at these depths, batch 1, seq 4,096
LM_TRAIN_PARITY = dict(layers=2, batch=1, seq=64, steps=2)  # fp32, full width
GNN_WARM, GNN_TIMED = 1, 2  # 3 timed steps until phase 21 needed the time
GNN_TIMED_SMALL = 11  # the small cells' timed steps: 12 losses, held to JAX's
# (arch, shape) -> the factor both n and e are cut by (the average degree kept):
# the card holds the uncut graph nowhere else (PERF.md section 4 has the reckoning);
# Equiformer's ogb_products 160, not the 114 the card holds, for the run's time
GNN_CUTS = {("meshgraphnet", "ogb_products"): 9, ("nequip", "ogb_products"): 8,
            ("equiformer-v2", "ogb_products"): 160, ("equiformer-v2", "minibatch_lg"): 3}
GNN_SMALL = ("full_graph_sm", "molecule")  # the cells held to JAX's losses
# JAX's losses over 12 train steps at each small cell's published config,
# from the port's seed-0 weights drawn on the CPU (the cells' own), on the
# seed-0 batch: ``python tests/test_torch_gnn.py ARCH SHAPE 12 --jax-only``
# prints them.  At lr 1e-3 JAX's loss blows up on three cells: MGN's and
# Equiformer's ``molecule`` at step 1, Equiformer's ``full_graph_sm`` at
# step 8.  From a blow-up on, the two runs' rounding differences grow with
# it (three steps after it the card's Equiformer ``full_graph_sm`` loss was
# 20% from JAX's, the port's on the CPU 13%), so the card's losses are held
# to JAX's within ``GNN_TRAJ_RTOL`` through the first step at which JAX's
# more than doubles, and within a factor ``GNN_TRAJ_AFTER`` after it.
GNN_JAX_LOSSES = {
    ("gat-cora", "full_graph_sm"): [
        1.9509204626083374, 1.9227441549301147, 1.8955588340759277, 1.869134545326233,
        1.8433507680892944, 1.8181401491165161, 1.7934634685516357, 1.769277572631836,
        1.7455443143844604, 1.7222180366516113, 1.6992645263671875, 1.6766437292099],
    ("meshgraphnet", "full_graph_sm"): [
        2.3286147117614746, 3.6298084259033203, 3.210195779800415, 3.130181074142456,
        2.57145094871521, 2.319948196411133, 1.9747837781906128, 1.9072424173355103,
        1.8937968015670776, 1.8433680534362793, 1.7471431493759155, 1.691326379776001],
    ("nequip", "full_graph_sm"): [
        1.9459035396575928, 1.945787787437439, 1.9456424713134766, 1.94546377658844,
        1.9452425241470337, 1.9449764490127563, 1.9446535110473633, 1.944257140159607,
        1.9437776803970337, 1.943207025527954, 1.9425315856933594, 1.9417349100112915],
    ("gat-cora", "molecule"): [
        3.9792447090148926, 3.627094030380249, 3.305337429046631, 3.013028144836426,
        2.749272346496582, 2.513209819793701, 2.30413556098938, 2.1212024688720703,
        1.9634721279144287, 1.8298218250274658, 1.7187837362289429, 1.6283862590789795],
    ("meshgraphnet", "molecule"): [
        39.51372528076172, 27269.10546875, 1925.3211669921875, 2690.3701171875,
        2.7261288166046143, 516.2185668945312, 31.978775024414062, 1106.783447265625,
        1282.251953125, 281.1732177734375, 193.51620483398438, 451.01617431640625],
    ("equiformer-v2", "full_graph_sm"): [
        1.951783537864685, 1.875474214553833, 1.8005472421646118, 1.7187784910202026,
        1.622243046760559, 1.4963304996490479, 1.3169223070144653, 1.066142201423645,
        7.323652744293213, 11151.771484375, 5751.35205078125, 95544.2890625],
    ("equiformer-v2", "molecule"): [
        2.6650915145874023, 144.502685546875, 78.6136703491211, 13.45999813079834,
        5.411147117614746, 7.718297481536865, 1.4694896936416626, 6.289836883544922,
        9.083793640136719, 4.714104175567627, 0.9811428785324097, 3.7242109775543213],
    ("nequip", "molecule"): [
        1.0967168807983398, 1.0988013744354248, 1.0976345539093018, 1.095823884010315,
        1.0957611799240112, 1.0959314107894897, 1.0954951047897339, 1.0948041677474976,
        1.094363808631897, 1.0941343307495117, 1.0935760736465454, 1.092698335647583],
}
GNN_TRAJ_RTOL = 2e-2  # the card's loss a step against JAX's, to its blow-up
GNN_TRAJ_AFTER = 2.0  # the card's loss over JAX's, or JAX's over it, after the blow-up


def held_steps(want) -> int:
    """The steps of a small cell's losses held to JAX's ``want`` within
    ``GNN_TRAJ_RTOL``: through the first at which JAX's loss more than
    doubles, else all."""
    return next((i + 1 for i in range(1, len(want)) if want[i] > 2 * want[i - 1]), len(want))


GNN_PARITY = dict(n=500, e=2000, d_in=12, n_classes=5, n_graphs=4)
GNN_PARITY_RTOL = 1e-5  # forward, card against CPU, of its largest magnitude
# reddit as minibatch_lg's comment has it: 232,965 nodes, 114.6M edges
SAMPLER = dict(n_nodes=232_965, avg_degree=492, fanouts=(15, 10), seeds=1024)


def adamw_bytes(params) -> int:
    """The bytes one AdamW update must move: each parameter's gradient and
    value read and its value written (their dtype), its fp32 ``m`` and ``v``
    read and written."""
    return sum(p.numel() * (3 * p.element_size() + 16) for p in params.values())


def lm_train_once(cfg, batch: int, seq: int, steps: int, rng_seed: int = 0):
    """``steps`` ``lm_train_step`` steps of a fresh seed-0 ``cfg`` model on
    the card at ``batch`` x ``seq`` (ids below ``LM_TRAIN_IDS``, labels the
    next id); -> ``run_steps``' dict with the peak bytes and the parameter
    count.  Everything is freed before it returns."""
    import torch

    from repro_torch.configs import cells
    from repro_torch.models import transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=CARD).manual_seed(rng_seed)
    model = transformer.Transformer(cfg, device=CARD, seed=0)
    marks = []
    step, opt, params = cells.lm_train_step(cfg, model, event_adamw(
        marks, lr=1e-4, weight_decay=0.1))
    state = opt.init(params)
    batches = []
    for _ in range(steps):
        ids = torch.randint(0, LM_TRAIN_IDS, (batch, seq + 1), generator=gen, device=CARD,
                            dtype=torch.int32)
        batches.append((ids[:, :-1].contiguous(), ids[:, 1:].contiguous()))
    out = run_steps(step, params, state, batches, marks)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["n_params"] = sum(p.numel() for p in params.values())
    out["adam_bytes"] = adamw_bytes(params)
    del model, step, params, state, out["params"], out["state"], batches
    torch.cuda.empty_cache()
    return out


def lm_cpu_steps(cfg, model, data, out: dict) -> None:
    """``lm_train_step`` steps of ``model`` on the CPU, one a token array of
    ``data`` (inputs and next-id labels): ``out["cpu"]`` gets [[loss,
    grad_norm]] and the params, or ``out["error"]`` the exception (run in a
    thread beside the card's work)."""
    import numpy as np

    from repro_torch.configs import cells

    try:
        t0 = time.perf_counter()
        step, opt, params = cells.lm_train_step(cfg, model)
        state = opt.init(params)
        ms, out["step_s"] = [], [time.perf_counter() - t0]
        for ids in data:
            params, state, met = step(params, state, ids[:, :-1], ids[:, 1:])
            ms.append([float(met["loss"]), float(met["grad_norm"])])
            out["step_s"].append(time.perf_counter() - t0 - sum(out["step_s"]))
        out["cpu"] = (np.array(ms), {k: v.detach() for k, v in params.items()})
    except BaseException as e:  # re-raised by the phase after the join
        out["error"] = e


def phase_lm_train(kernel_mods, batch: int = LM_TRAIN_BATCH):
    """qwen2.5-3b trains at its published widths, all 36 layers, bf16, with
    per-layer remat, through ``configs.cells.lm_train_step`` (the JAX cell's
    AdamW(lr=1e-4, weight_decay=0.1)) at ``batch`` x 4,096 (``train_4k``,
    the batch cut from 256): 1 warm-up and 2 timed steps, step,
    forward+backward and AdamW ms by CUDA events, the peak memory and the
    loss (finite, falling), each beside its bound.  Remat off against on at
    2 and 4 layers, batch 1, seq 4,096: their peaks, and what that gives
    for 36 layers.  In fp32 at 2 layers, full width, 2 steps on the card
    against a CPU copy of the same weights (loss, grad_norm, each leaf's
    update); the CPU's steps run in a thread while the card trains.  No
    K1-K4 launch (their counts set to 0 before and read after)."""
    import copy
    import dataclasses
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import cells, registry
    from repro_torch.configs.registry import LM_TRAIN
    from repro_torch.models import transformer

    reset(kernel_mods)
    seq = LM_TRAIN["seq"]
    cfg = registry.get_arch("qwen2.5-3b").config()

    # ---- the fp32 CPU reference starts first, in a thread (the card's copy
    # of the same weights trains after the full-width runs)
    t_ref = time.perf_counter()
    P = LM_TRAIN_PARITY
    pc = dataclasses.replace(cfg, n_layers=P["layers"], dtype=torch.float32)
    model = transformer.Transformer(pc, device=CARD, seed=1)
    p0 = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    host = copy.deepcopy(model).to("cpu")
    del model
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(2)
    data = [torch.randint(0, pc.vocab, (P["batch"], P["seq"] + 1), generator=gen,
                          dtype=torch.int32) for _ in range(P["steps"])]
    res = {}
    ref = threading.Thread(target=lm_cpu_steps, args=(pc, host, data, res), daemon=True)
    ref.start()

    t0 = time.perf_counter()
    r = lm_train_once(cfg, batch, seq, LM_TRAIN_WARM + LM_TRAIN_TIMED)
    timed = slice(LM_TRAIN_WARM, None)
    losses = r["losses"]
    check(all(np.isfinite(losses)) and all(np.isfinite(r["norms"])),
          f"qwen training: a loss or grad_norm is not finite: {losses} {r['norms']}")
    check(losses[-1] < losses[0], f"qwen training: the loss did not fall: {losses}")
    tokens = batch * seq
    ops = 6 * r["n_params"] * tokens * 4 / 3
    fb_bound = ops / BF16_FLOPS_PER_S * 1e3
    adam_bound = r["adam_bytes"] / HBM_BYTES_PER_S * 1e3
    fb, adam, st = (pct(r[k][timed], 50) for k in ("fb_ms", "adam_ms", "step_ms"))
    log(f"qwen2.5-3b train_4k at full width ({r['n_params']} parameters, {cfg.n_layers} "
        f"layers, bf16, remat on), batch {batch} (cut from {LM_TRAIN['batch']}) x {seq}: step "
        f"p50 {st:.3f} ms (bound {fb_bound + adam_bound:.3f}), forward+backward p50 "
        f"{fb:.3f} ms (bound {fb_bound:.3f} ms by operations: 6 N tokens x 4/3 = "
        f"{ops / 1e12:.1f} TFLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; "
        f"{fb_bound / fb:.3f} of it), AdamW p50 {adam:.3f} ms (bound {adam_bound:.3f} ms by "
        f"bytes: {r['adam_bytes'] / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"{adam_bound / adam:.3f} of it); {tokens / st * 1e3:.1f} tokens/s (CUDA events, "
        f"{LM_TRAIN_TIMED} steps after {LM_TRAIN_WARM} warm-up; first step "
        f"{r['step_ms'][0]:.3f} ms); peak {r['peak'] / 1e9:.3f} GB (max_memory_allocated) "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"  losses {[round(x, 5) for x in losses]}; grad norms "
        f"{[round(x, 5) for x in r['norms']]}")

    # ---- what remat buys: off against on, batch 1, at two depths
    t0 = time.perf_counter()
    peaks = {}
    for depth in REMAT_DEPTHS:
        for remat in (True, False):
            c = dataclasses.replace(cfg, n_layers=depth, remat=remat)
            q = lm_train_once(c, 1, seq, 1)
            check(np.isfinite(q["losses"][0]), f"remat {remat} at {depth} layers: loss "
                  f"{q['losses'][0]}")
            peaks[(depth, remat)] = q["peak"] / 1e9
    d0, d1 = REMAT_DEPTHS
    layer_gb = (cfg.param_count() - dataclasses.replace(cfg, n_layers=0).param_count()) \
        / cfg.n_layers * 12 / 1e9  # bf16 weight and gradient, fp32 m and v
    per = {rm: (peaks[(d1, rm)] - peaks[(d0, rm)]) / (d1 - d0) for rm in (True, False)}
    full = {rm: peaks[(d1, rm)] + (cfg.n_layers - d1) * per[rm] for rm in (True, False)}
    log(f"remat on against off at batch 1 x {seq} (one step each, peak GB): "
        + ", ".join(f"{d} layers {peaks[(d, True)]:.3f} on / {peaks[(d, False)]:.3f} off"
                    for d in REMAT_DEPTHS)
        + f"; a layer adds {per[True]:.3f} GB on, {per[False]:.3f} GB off (its weights, "
        f"gradients and moments, {layer_gb:.3f} GB, included); at {cfg.n_layers} layers, "
        f"batch 1: {full[True]:.1f} GB on, {full[False]:.1f} GB off (the card has "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB) "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- fp32 at cut depth, full width: the card against the CPU thread
    t0 = time.perf_counter()
    model = transformer.Transformer(pc, device=CARD, seed=1)
    model.load_state_dict(p0)
    step, opt, params = cells.lm_train_step(pc, model)
    state = opt.init(params)
    ms = []
    for ids in data:
        ids = ids.to(CARD)
        params, state, met = step(params, state, ids[:, :-1], ids[:, 1:])
        ms.append([float(met["loss"]), float(met["grad_norm"])])
    mc, pcard = np.array(ms), {k: v.detach().cpu() for k, v in params.items()}
    del model, step, params, state
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t0
    ref.join()
    if "error" in res:
        raise res["error"]
    mh, phost = res["cpu"]
    l_err, g_err = (float(np.max(np.abs(mc[:, i] - mh[:, i]) / np.abs(mh[:, i])))
                    for i in (0, 1))
    p_err = update_err(pcard, phost, p0, 1e-4)
    check(l_err <= TRAIN_LOSS_RTOL and g_err <= TRAIN_GNORM_RTOL and p_err <= TRAIN_UPDATE_RTOL,
          f"qwen fp32 training: the card's steps differ from the CPU's (loss {l_err:.3g}, "
          f"grad_norm {g_err:.3g} relative; params {p_err:.3g} of the update)")
    log(f"qwen2.5-3b at full width, {P['layers']} layers, fp32: {P['steps']} steps at "
        f"{P['batch']} x {P['seq']} on the card against a CPU copy: loss within {l_err:.3g} "
        f"(rtol {TRAIN_LOSS_RTOL}), grad_norm within {g_err:.3g} (rtol {TRAIN_GNORM_RTOL}), "
        f"params within {p_err:.3g} of each leaf's update (rtol {TRAIN_UPDATE_RTOL}); losses "
        f"{[round(float(x), 6) for x in mc[:, 0]]} (card {card_s:.1f} s; the CPU's thread "
        f"{time.perf_counter() - t_ref:.1f} s from its start, beside the card's runs: setup and "
        f"steps {[round(x, 1) for x in res['step_s']]} s)")
    del res, pcard, phost, host
    launches = counts(kernel_mods)
    check(not any(launches.values()), f"the LM training phase launched K1-K4: {launches}")
    log(f"launches of K1-K4 in the LM training phase: {launches}")


def gnn_cells():
    """Every (arch, shape) GNN cell with its config and the graph it trains
    on: (arch, shape, cfg, n, e, cut)."""
    from repro_torch.configs import registry

    out = []
    for shape, p in registry.GNN_SHAPES.items():
        for arch, entry in registry.ARCHS.items():
            if entry.family != "gnn":
                continue
            cut = GNN_CUTS.get((arch, shape), 1)
            out.append((arch, shape, registry.gnn_cell_config(arch, shape),
                        -(-p["n"] // cut), -(-p["e"] // cut), cut))
    return out


def gnn_bound(flops: float, nbytes: int, dtype) -> tuple:
    """(ms, "bytes" | "operations"): the step's counted matrix-product
    operations at the dtype's peak, or its bytes at the memory rate."""
    import torch

    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gnn_train_cell(arch, shape, cfg, n, e, data_cache: dict) -> dict:
    """One GNN cell on the card: a fresh seed-0 model, ``GNN_WARM`` +
    ``GNN_TIMED`` steps (``GNN_TIMED_SMALL`` on the small cells) on one
    ``random_graph`` batch (the warm-up under
    ``FlopCounterMode``, which counts the matrix products of a step, the
    recomputation included); -> run_steps' dict with peak, flops, bytes."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import cells, registry
    from repro_torch.data import graphs
    from repro_torch.models.gnn import common

    p = registry.GNN_SHAPES[shape]
    key = (shape, n, e)
    if key not in data_cache:
        data_cache.clear()
        t0 = time.perf_counter()
        b = graphs.random_graph(n, e, p["d_feat"], n_classes=max(p["n_classes"], 1), seed=0,
                                task=p["task"], n_graphs=p["n_graphs"])
        data_cache[key] = (common.to_device(b, CARD), time.perf_counter() - t0)
    batch, gen_s = data_cache[key]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    module = cells.GNN_FAMILIES[arch][0]
    # drawn on the CPU, as tests/test_torch_gnn.py::cell_trajectories draws
    # the weights JAX's reference losses start from
    model = common.Model(module, cfg, device="cpu", seed=0).to(CARD)
    marks = []
    step, opt, params = cells.gnn_train_step(arch, cfg, model, event_adamw(marks, lr=1e-3),
                                             n_graphs=p["n_graphs"])
    state = opt.init(params)
    with FlopCounterMode(display=False) as fc:
        params, state, m0 = step(params, state, batch)
    n_timed = GNN_TIMED_SMALL if shape in GNN_SMALL else GNN_TIMED
    out = run_steps(step, params, state, [(batch,)] * n_timed, marks)
    out["losses"] = [float(m0["loss"])] + out["losses"]
    out["peak"] = torch.cuda.max_memory_allocated()
    out["flops"] = fc.get_total_flops()
    out["bytes"] = sum(t.numel() * t.element_size() for t in batch) + adamw_bytes(params)
    out["n_params"] = sum(v.numel() for v in params.values())
    out["gen_s"] = gen_s
    del model, step, params, state, out["params"], out["state"]
    torch.cuda.empty_cache()
    return out


def phase_gnn(kernel_mods):
    """The four GNNs train at their published widths (GAT 2 x 8 x 8 heads,
    MGN 15 x 128, NequIP 5 x 32 at l_max 2, Equiformer 12 x 128 at l_max 6,
    m_max 2, 8 heads; remat on) on every ``GNN_SHAPES`` cell, 16 cells,
    through ``configs.cells.gnn_train_step`` under ``gnn_cell_config``, on
    ``random_graph`` batches (``GNN_CUTS`` the graphs cut where the card
    cannot hold them): step, forward+backward and AdamW ms, peak memory,
    the loss over 2 steps after 1 warm-up (finite everywhere; 11 on the
    small cells, each loss within ``GNN_TRAJ_RTOL`` of JAX's from the same
    weights to JAX's blow-up and within ``GNN_TRAJ_AFTER`` times after it,
    and falling where JAX's falls), each beside its
    bound.  At each arch's smoke config, both tasks, in fp32: forward,
    loss and one step on the card against the CPU.  One
    ``NeighborSampler`` batch at ``minibatch_lg``'s fanout over a
    reddit-sized CSR graph, its dedup ratio and host ms, and one GAT step
    on it.  No K1-K4 launch."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import cells, registry
    from repro_torch.data import graphs
    from repro_torch.models import layers
    from repro_torch.models.gnn import common

    reset(kernel_mods)
    data_cache = {}
    for arch, shape, cfg, n, e, cut in gnn_cells():
        t0 = time.perf_counter()
        r = gnn_train_cell(arch, shape, cfg, n, e, data_cache)
        losses = r["losses"]
        check(all(np.isfinite(losses)) and all(np.isfinite(r["norms"])),
              f"{arch}/{shape}: a loss or grad_norm is not finite: {losses} {r['norms']}")
        if shape in GNN_SMALL:
            want = np.array(GNN_JAX_LOSSES[(arch, shape)])
            h = held_steps(want)
            check(len(losses) == len(want), f"{arch}/{shape}: {len(losses)} losses")
            err = float(np.max(np.abs(np.array(losses[:h]) - want[:h]) / np.abs(want[:h])))
            check(err <= GNN_TRAJ_RTOL,
                  f"{arch}/{shape}: the first {h} losses differ from JAX's by {err:.3g} (rtol "
                  f"{GNN_TRAJ_RTOL}): {losses} against {want.tolist()}")
            ratio = float(np.max(np.abs(np.log(np.array(losses[h:]) / want[h:])), initial=0.0))
            check(ratio <= np.log(GNN_TRAJ_AFTER),
                  f"{arch}/{shape}: after step {h} a loss is {np.exp(ratio):.3g}x from JAX's "
                  f"(at most {GNN_TRAJ_AFTER}x): {losses} against {want.tolist()}")
            log(f"  {arch}/{shape}: the first {h} of {len(want)} losses within {err:.3g} of "
                f"JAX's from the same weights (rtol {GNN_TRAJ_RTOL}); after them within "
                f"{float(np.max(np.abs(np.array(losses) - want) / np.abs(want))):.3g} "
                f"(a factor {GNN_TRAJ_AFTER} allowed)")
            check(losses[-1] < losses[0] or want[-1] >= want[0],
                  f"{arch}/{shape}: the loss did not fall: {losses}")
        b_ms, b_by = gnn_bound(r["flops"], r["bytes"], cfg.dtype)
        st, fb, ad = (pct(r[k], 50) for k in ("step_ms", "fb_ms", "adam_ms"))
        p = registry.GNN_SHAPES[shape]
        log(f"{arch}/{shape} ({r['n_params']} parameters, {str(cfg.dtype).removeprefix('torch.')}"
            f"): n {n} e {e}" + (f" (cut {cut}x from {p['n']} / {p['e']})" if cut > 1 else "")
            + f": step p50 {st:.3f} ms, forward+backward {fb:.3f}, AdamW {ad:.3f} (CUDA events, "
            f"{len(r['step_ms'])} after {GNN_WARM} warm-up); bound {b_ms:.3f} ms by {b_by} "
            f"({r['flops'] / 1e12:.3f} TFLOP of matrix products counted, or "
            f"{r['bytes'] / 1e9:.3f} GB: the graph read once and AdamW's), {b_ms / st:.3f} of "
            f"the step; peak {r['peak'] / 1e9:.3f} GB; losses {[round(x, 5) for x in losses]} "
            f"(graph made in {r['gen_s']:.1f} s; cell {time.perf_counter() - t0:.1f} s)")
    del data_cache
    torch.cuda.empty_cache()

    # ---- fp32 smoke configs, both tasks: the card against the CPU
    t0 = time.perf_counter()
    P = GNN_PARITY
    worst = {}
    for arch, (module, _) in cells.GNN_FAMILIES.items():
        for task in ("node_cls", "graph_reg"):
            ng = P["n_graphs"] if task == "graph_reg" else 1
            cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(), d_in=P["d_in"],
                                      task=task, n_classes=P["n_classes"])
            b = graphs.random_graph(P["n"], P["e"], P["d_in"], n_classes=P["n_classes"],
                                    seed=9, task=task, n_graphs=ng)
            model = common.Model(module, cfg, device=CARD, seed=4)
            p0 = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
            res = {}
            for dev in (CARD, "cpu"):
                m = model if dev == CARD else common.Model(module, cfg, device="cpu")
                if dev == "cpu":
                    m.load_state_dict(p0)
                batch = common.to_device(b, dev)
                with torch.no_grad():
                    extra = () if arch == "gat-cora" else (ng,)
                    fwd = module.forward(m.params(), cfg, batch, *extra).cpu()
                    loss = float(module.loss_fn(m.params(), cfg, batch, ng))
                step, opt, params = cells.gnn_train_step(arch, cfg, m, n_graphs=ng)
                params, _, met = step(params, opt.init(params), batch)
                res[dev] = (fwd, loss, float(met["loss"]), float(met["grad_norm"]),
                            {k: v.detach().cpu() for k, v in params.items()})
            (fc, lc, sc, gc, pc), (fh, lh, sh, gh, ph) = res[CARD], res["cpu"]
            errs = dict(forward=float((fc - fh).abs().max() / fh.abs().max()),
                        loss=abs(lc - lh) / abs(lh), step_loss=abs(sc - sh) / abs(sh),
                        grad_norm=abs(gc - gh) / abs(gh), update=update_err(pc, ph, p0, 1e-3))
            check(errs["forward"] <= GNN_PARITY_RTOL and errs["loss"] <= TRAIN_LOSS_RTOL
                  and errs["step_loss"] <= TRAIN_LOSS_RTOL
                  and errs["grad_norm"] <= TRAIN_GNORM_RTOL
                  and errs["update"] <= TRAIN_UPDATE_RTOL,
                  f"{arch} {task} (smoke, fp32): the card differs from the CPU: {errs}")
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
    log(f"GNN smoke configs in fp32, both tasks ({P['n']} nodes, {P['e']} edges), the card "
        f"against the CPU, largest over the 8: forward {worst['forward']:.3g} of its largest "
        f"(tolerance {GNN_PARITY_RTOL}), loss {worst['loss']:.3g}, a step's loss "
        f"{worst['step_loss']:.3g} (rtol {TRAIN_LOSS_RTOL}), grad_norm {worst['grad_norm']:.3g} "
        f"(rtol {TRAIN_GNORM_RTOL}), params {worst['update']:.3g} of each leaf's update (rtol "
        f"{TRAIN_UPDATE_RTOL}; the card's index_add is atomic, in no fixed order) "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the neighbor sampler at minibatch_lg's fanout
    t0 = time.perf_counter()
    S = SAMPLER
    g = graphs.CSRGraph.random(S["n_nodes"], S["avg_degree"], seed=0)
    made = time.perf_counter() - t0
    sampler = graphs.NeighborSampler(g, S["fanouts"], seed=0)
    seeds = np.random.default_rng(1).choice(S["n_nodes"], S["seeds"], replace=False)
    t0 = time.perf_counter()
    s = sampler.sample(seeds)
    sample_ms = (time.perf_counter() - t0) * 1e3
    p = registry.GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    b = sampler.batch(seeds, p["d_feat"], n_classes=p["n_classes"])
    batch_ms = (time.perf_counter() - t0) * 1e3
    check(b.n_nodes == p["n"] and b.n_edges == p["e"],
          f"the sampler's batch is {b.n_nodes} x {b.n_edges}, minibatch_lg is {p['n']} x {p['e']}")
    n_real, e_real = int(s["node_mask"].sum()), int(s["edge_mask"].sum())
    cfg = registry.gnn_cell_config("gat-cora", "minibatch_lg")
    model = common.Model(cells.GNN_FAMILIES["gat-cora"][0], cfg, device=CARD)
    step, opt, params = cells.gnn_train_step("gat-cora", cfg, model)
    _, _, met = step(params, opt.init(params), common.to_device(b, CARD))
    check(bool(torch.isfinite(met["loss"])), "GAT on the sampled batch: loss not finite")
    log(f"NeighborSampler over a reddit-sized CSR graph ({S['n_nodes']} nodes, "
        f"{int(g.indptr[-1])} edges, made in {made:.1f} s), fanout {S['fanouts']} over "
        f"{S['seeds']} seeds: {round(s['dedup_ratio'] * n_real)} sampled ids, "
        f"{n_real} distinct (dedup_ratio {s['dedup_ratio']:.3f}: each distinct node's "
        f"features gathered once), {e_real} edges; sample {sample_ms:.1f} ms, batch "
        f"{batch_ms:.1f} ms on the host; padded to minibatch_lg's {p['n']} x {p['e']}; a GAT "
        f"step on it: loss {float(met['loss']):.5f}")
    del model, step, params, g, sampler, b
    torch.cuda.empty_cache()
    launches = counts(kernel_mods)
    check(not any(launches.values()), f"the GNN phase launched K1-K4: {launches}")
    log(f"launches of K1-K4 in the GNN phase: {launches}")


# ------------------------------------------------------------------ slice 12

COLL_MESH = (2, 2)  # (data, model) ranks, all on the one card
COLL_DEVICE = "cuda"  # the ranks' device (a rehearsal on the CPU sets "cpu")
COLL_KEYS = 1 << 24  # the shuffle's keys: rdfizer/shuffle_dedup, 2^22 slots a rank
COLL_TIMEOUT = 300  # s: each collective, and the ranks' whole run
WD_COLL_TIMED = 8  # warm sharded Wide & Deep forwards timed a mode
LM_TOKENS = (4, 512)  # the vocab-parallel and MoE token batch: 2,048 tokens
MOE_RTOL = 1e-5  # fp32 sharded MoE against _forward_local: of the largest |y|
BF16_NORM_TOL = 2e-2  # bf16 sharded MoE: ||a - b|| / ||b|| against _forward_local in bf16
INT8_NORM_TOL = 5e-2  # the int8 gather's bf16 output against the plain gather's


def _ranks_wall(fn):
    """``fn()``'s result and its wall ms on this rank, from a barrier to the
    end of a synchronize and a second barrier (the slowest rank's time)."""
    import torch.distributed as dist

    dist.barrier()
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    dist.barrier()
    return out, (time.perf_counter() - t0) * 1e3


def _sync() -> None:
    import torch

    if COLL_DEVICE == "cuda":
        torch.cuda.synchronize()


def _norm_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _counted(rep, name, fn):
    """``fn()`` under the dry-run's collective counter: the arm's live
    collectives on this rank, by JAX's rule, into ``rep``."""
    from repro_torch.launch.dryrun import Collectives

    with Collectives() as counter:
        out = fn()
    _sync()
    rep.setdefault("live_collectives", {})[name] = counter.record()
    return out


def _coll_shuffle(mesh, rep, join_path):
    """The shuffle as rdfizer/shuffle_dedup on a 4-device mesh, the PJTT and
    the probe over the 1M OJM join, on this rank; rank 0 holds the gathered
    results to the stacked arm's at ``n_shards = 4``."""
    import hashlib

    import torch

    from repro_torch.configs import cells
    from repro_torch.core import distributed as D
    from repro_torch.models import sharding

    rank0 = torch.distributed.get_rank() == 0
    n = mesh.size
    spec = sharding.P(mesh.axis_names)
    cell = cells.rdfizer_shuffle_cell(mesh, COLL_KEYS, device=COLL_DEVICE, fake=False)
    thi, tlo, khi, klo, valid = cell.args
    blocks = [sharding.local_block(x, spec, mesh) for x in (thi, tlo, khi, klo, valid)]
    (table, is_new, ovf), ms = _ranks_wall(lambda: D.distributed_insert(
        mesh, D.ShardedPTT(blocks[0], blocks[1]), *blocks[2:]))
    rep["shuffle_ms"], rep["shuffle_ovf"] = ms, bool(ovf)
    _counted(rep, "shuffle", lambda: D.distributed_insert(
        mesh, D.ShardedPTT(blocks[0], blocks[1]), *blocks[2:]))
    rep["table_bytes"] = 2 * thi.numel() * 4
    got = [sharding.gather_block(x, spec, mesh) for x in (table.hi, table.lo, is_new)]
    del blocks, table
    if rank0:
        keys = (khi.long() << 32) | (klo.long() & 0xFFFFFFFF)
        rep["n_new"] = int(got[2].sum())
        rep["n_distinct"] = int(torch.unique(keys[valid]).numel())
        del keys
        _sync()
        t0 = time.perf_counter()
        st, snew, sovf = D.distributed_insert(n, D.ShardedPTT(thi, tlo), khi, klo, valid)
        _sync()
        rep["stacked_ms"] = (time.perf_counter() - t0) * 1e3
        rep["shuffle_equal_stacked"] = (torch.equal(got[0], st.hi) and torch.equal(
            got[1], st.lo) and torch.equal(got[2], snew) and bool(sovf) == bool(ovf))
        del st, snew
    del cell, thi, tlo, khi, klo, valid, got
    torch.cuda.empty_cache()

    j = torch.load(join_path)
    pk, ps, ck = (j[k].to(COLL_DEVICE) for k in ("pk", "ps", "ck"))
    K = j["K"]

    def pad(x):  # -1 lanes are invalid and are not sent
        return torch.cat([x, x.new_full((-len(x) % n,), -1)])

    pk, ps, ck_pad = pad(pk), pad(ps), pad(ck)
    (idx, bovf), rep["build_ms"] = _ranks_wall(lambda: D.build_distributed_pjtt(
        mesh, *(sharding.local_block(x, spec, mesh) for x in (pk, ps))))
    ck_block = sharding.local_block(ck_pad, spec, mesh)
    (subs, pvalid, povf), rep["probe_ms"] = _ranks_wall(
        lambda: D.distributed_ojm_probe(mesh, idx, ck_block, K))
    rep["pjtt_ovf"] = bool(bovf) or bool(povf)
    got = [sharding.gather_block(x, spec, mesh) for x in (idx.skeys, idx.ssubj, subs, pvalid)]
    if rank0:
        sidx, sbovf = D.build_distributed_pjtt(n, pk, ps)
        ssubs, svalid, spovf = D.distributed_ojm_probe(n, sidx, ck_pad, K)
        rep["pjtt_equal_stacked"] = all(torch.equal(a, b) for a, b in zip(
            got, (sidx.skeys, sidx.ssubj, ssubs, svalid))) and (
            bool(sbovf) or bool(spovf)) == rep["pjtt_ovf"]
        big = 2**31 - 1
        rows = torch.where(got[3], got[2], big)[: len(ck)].sort(dim=1).values
        rep["rowsets_sha256"] = hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()
        rep["join_rows"] = (len(j["pk"]), len(ck), K)
    del idx, subs, pvalid, got
    torch.cuda.empty_cache()


def _coll_wide_deep(mesh, rep):
    """Wide & Deep at its published width at serve_p99, plain and with
    ``dedup_cap``, on this rank's batch block; rank 0 holds the gathered
    logits to the one-process forward from the same weights."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import wide_deep
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.models import sharding
    from repro_torch.models.recsys import WideDeep

    cfg = wide_deep.config()
    F, V, B = cfg.n_sparse, cfg.vocab_per_field, RECSYS_SHAPES["serve_p99"]
    rng = np.random.default_rng(0)
    zipf = (np.minimum(rng.zipf(1.3, size=(B, F, 1)), V) - 1).astype(np.int32)
    dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    # a cap no rank's ids can pass: the whole batch's distinct ids
    cap = len(np.unique(zipf + (np.arange(F, dtype=np.int32) * V)[None, :, None]))
    sp, de = torch.from_numpy(zipf).to(COLL_DEVICE), torch.from_numpy(dense).to(COLL_DEVICE)
    bs = sharding.token_spec(B, mesh)
    sp_b, de_b = sharding.local_block(sp, bs, mesh), sharding.local_block(de, bs, mesh)
    model = WideDeep(cfg, device=COLL_DEVICE, seed=0, mesh=mesh).eval()
    torch.cuda.empty_cache()
    rep["wd_table_block"] = tuple(model.embed.shape)
    logits = {}
    with torch.inference_mode(), sharding.set_mesh(mesh):
        for mode, c in {"plain": cfg, "dedup": dataclasses.replace(cfg, dedup_cap=cap)}.items():
            model.cfg = c
            out = _counted(rep, f"wide_deep_{mode}", lambda: model(sp_b, de_b))
            times = [_ranks_wall(lambda: model(sp_b, de_b))[1] for _ in range(WD_COLL_TIMED)]
            logits[mode] = sharding.gather_block(out, bs, mesh)
            rep[f"wd_{mode}_ms"] = statistics.median(times)
    rep["wd_cap"] = cap
    del model
    torch.cuda.empty_cache()
    if torch.distributed.get_rank() == 0:
        one = WideDeep(cfg, device=COLL_DEVICE, seed=0).eval()
        with torch.inference_mode():
            ref = one(sp, de)
        del one
        torch.cuda.empty_cache()
        for mode, got in logits.items():
            rep[f"wd_{mode}_ok"] = (got.shape == ref.shape and bool(torch.isfinite(got).all())
                                    and torch.allclose(got, ref, rtol=1e-5, atol=1e-6))
            rep[f"wd_{mode}_err"] = float((got - ref).abs().max())


def _coll_vocab(mesh, rep):
    """qwen2.5-3b's (V, d) table at 151,936 x 2,048 sharded P("model",
    "data"): ``embed`` (bf16, exact) and ``tied_logits`` (fp32 within rtol
    1e-5, atol 1e-6; bf16 within one bf16 step of the largest logit) on
    this rank's tokens against the no-mesh forms, block by block."""
    import torch

    from repro_torch.configs import qwen2_5_3b
    from repro_torch.models import sharding, vocab_parallel

    cfg = qwen2_5_3b.config()
    V, d, n = cfg.vocab, cfg.d_model, LM_TOKENS[0] * LM_TOKENS[1]
    dev = COLL_DEVICE
    gen = torch.Generator(device=dev).manual_seed(2)
    table = (torch.randn((V, d), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    ids = torch.randint(0, V, (n,), generator=gen, device=dev)
    h = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    ts = sharding.token_spec(n, mesh)
    tspec, lspec = sharding.P("model", "data"), sharding.P(ts[0], "model")
    tb, ids_b, h_b = (sharding.local_block(x, s, mesh) for x, s in
                      ((table, tspec), (ids, ts), (h, ts)))
    with sharding.set_mesh(mesh):
        _counted(rep, "embed", lambda: vocab_parallel.embed(tb, ids_b))
        _counted(rep, "tied_logits", lambda: vocab_parallel.tied_logits(tb, h_b))
        rows, rep["embed_ms"] = _ranks_wall(lambda: vocab_parallel.embed(tb, ids_b))
        logits, rep["logits_ms"] = _ranks_wall(lambda: vocab_parallel.tied_logits(tb, h_b))
        logits32 = vocab_parallel.tied_logits(tb.float(), h_b.float())
    ok = torch.equal(rows, sharding.local_block(vocab_parallel.embed(table, ids), ts, mesh))
    ref = sharding.local_block(vocab_parallel.tied_logits(table, h), lspec, mesh)
    step = float(ref.float().abs().max()) * 2.0**-7
    err = float((logits.float() - ref.float()).abs().max())
    ok &= logits.shape == ref.shape and err <= step
    del ref
    ref32 = sharding.local_block(vocab_parallel.tied_logits(table.float(), h.float()), lspec,
                                 mesh)
    ok &= torch.allclose(logits32, ref32, rtol=1e-5, atol=1e-6)
    err32 = float((logits32 - ref32).abs().max())
    flags = sharding.pmax(torch.tensor([0 if ok else 1], device=dev), mesh.axis_names, mesh)
    errs = sharding.pmax(torch.tensor([err, err32], device=dev), mesh.axis_names, mesh)
    rep["vocab_ok"] = int(flags) == 0
    rep["vocab_err_bf16"], rep["vocab_err_fp32"] = (float(e) for e in errs)
    rep["vocab_blocks"] = (tuple(tb.shape), tuple(logits.shape))
    del table, tb, logits, logits32, ref32
    torch.cuda.empty_cache()


def _coll_moe(mesh, rep):
    """One mixtral-8x7b MoE layer at its widths on this rank's tokens: bf16
    with the plain and the int8 gather; fp32 at a capacity that drops no
    token against ``_forward_local`` (rank 0: every token with the plain
    gather, data row 0's with the int8 gather's dequantized weights)."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.configs import mixtral_8x7b
    from repro_torch.models import layers, moe, sharding, transformer

    lm = mixtral_8x7b.config()
    base = lm.moe_cfg
    E, k = base.n_experts, base.top_k
    nodrop = base._replace(capacity_factor=E / k)  # cap = n + 1: no expert can overflow
    n = LM_TOKENS[0] * LM_TOKENS[1]
    gen = torch.Generator(device=COLL_DEVICE).manual_seed(3)
    full = moe.init(gen, base, torch.float32, device=COLL_DEVICE)
    x = torch.randn((n, base.d_model), generator=gen, device=COLL_DEVICE)
    # one layer's MoE specs: router whole, gate/up (None, data, model), down (None, model, data)
    one = dataclasses.replace(lm, n_layers=1, scan_layers=False)
    specs = transformer.param_specs(one)["blocks"][0]["moe"]
    p32 = layers.nest(convert.shard_state_from_params(full, specs, mesh, COLL_DEVICE))
    p16 = {k_: (v.to(torch.bfloat16) if k_ != "router" else v) for k_, v in p32.items()}
    ts = sharding.token_spec(n, mesh)
    xb = sharding.local_block(x, ts, mesh)
    rank0 = torch.distributed.get_rank() == 0
    if not rank0:
        del full
    torch.cuda.empty_cache()
    out = {}
    x16 = xb.to(torch.bfloat16)
    with torch.inference_mode(), sharding.set_mesh(mesh):
        for name, cfg, p, xin in (
                ("bf16", base, p16, x16),
                ("bf16_int8", base._replace(quantized_gather=True), p16, x16),
                ("bf16_nodrop", nodrop, p16, x16),
                ("fp32", nodrop, p32, xb),
                ("fp32_int8", nodrop._replace(quantized_gather=True), p32, xb)):
            if name in ("bf16", "bf16_int8"):
                _counted(rep, f"moe_{name}", lambda: moe.forward(p, cfg, xin))
            (y, aux), ms = _ranks_wall(lambda: moe.forward(p, cfg, xin))
            out[name] = (y, aux)
            rep[f"moe_{name}_ms"] = ms
            rep[f"moe_{name}_finite"] = bool(torch.isfinite(y).all()) and bool(
                torch.isfinite(aux))
        # the pairs a rank's arm drops at 1.25, against the local arm's over all tokens
        rep["moe_dims"] = (base.d_model, base.d_ff, E, k)
        rep["moe_local_tokens"] = xb.shape[0]
        _, gidx, _ = moe._route(p32, base, xb)
        rep["moe_cap_sharded"] = moe.capacity(base, xb.shape[0])
        over = torch.bincount(gidx.reshape(-1).long(), minlength=E) - rep["moe_cap_sharded"]
        rep["moe_drop_sharded"] = int(sharding.psum(over.clamp(min=0).sum().reshape(1), "data"))
    ys = {name: sharding.gather_block(y, ts, mesh) for name, (y, _) in out.items()}
    rep["moe_aux"] = float(out["fp32"][1])
    rep["moe_int8_vs_plain_bf16"] = _norm_err(ys["bf16_int8"], ys["bf16"])
    if rank0:
        with torch.inference_mode():
            y_ref = moe._forward_local(full, nodrop, x[None])[0][0]
            rep["moe_fp32_err"] = float((ys["fp32"] - y_ref).abs().max() / y_ref.abs().max())
            # bf16 against bf16: the same routing (both route the bf16 tokens)
            full16 = {k_: (v.to(torch.bfloat16) if k_ != "router" else v)
                      for k_, v in full.items()}
            y16 = moe._forward_local(full16, nodrop, x[None].to(torch.bfloat16))[0][0]
            rep["moe_bf16_err"] = _norm_err(ys["bf16_nodrop"], y16)
            del y_ref, full16, y16
            # data row 0's weights as its ranks hold them after the int8 gather
            D_, M_ = mesh.sizes
            deq = {w: _dequantized_row(full[w], da, ma, 0, D_, M_)
                   for w, da, ma in (("gate", 1, 2), ("up", 1, 2), ("down", 2, 1))}
            rows0 = xb.shape[0]
            y_q = moe._forward_local({"router": full["router"], **deq}, nodrop,
                                     x[None, :rows0])[0][0]
            rep["moe_fp32_int8_err"] = float(
                (ys["fp32_int8"][:rows0] - y_q).abs().max() / y_q.abs().max())
            del deq, y_q
            _, gall, _ = moe._route(full, base, x)
            rep["moe_cap_local"] = moe.capacity(base, n)
            over = torch.bincount(gall.reshape(-1).long(), minlength=E) - rep["moe_cap_local"]
            rep["moe_drop_local"] = int(over.clamp(min=0).sum())
            auxes = [moe._route(full, base, x[i * rows0:(i + 1) * rows0])[2]
                     for i in range(mesh.sizes[0])]
            rep["moe_aux_ref"] = float(torch.stack(auxes).mean())
    del out, ys, p32, p16
    torch.cuda.empty_cache()


def _dequantized_row(W, da: int, ma: int, i: int, D: int, M: int):
    """An expert weight as data row ``i`` of a (D, M) mesh uses it after the
    int8 gather: for each model slice, every data block's int8 values
    dequantized with the scales of row ``i``'s own block."""
    import torch

    from repro_torch.models import moe

    out = []
    for wj in W.chunk(M, ma):
        blocks = wj.chunk(D, da)
        q = torch.cat([moe.quantize(b, (1, 2))[0] for b in blocks], da)
        out.append(q.float() * moe.quantize(blocks[i], (1, 2))[1])
    return torch.cat(out, ma)


def _collective_ranks(mesh, join_path):
    """Phase 21 on one rank of the (data, model) mesh: every arm in turn,
    then the launch counts of K1-K4 (none of these paths reaches them)."""
    import torch

    from repro_torch.kernels import bucket_dedup, hash_mix, nested_join, scan_join

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rep = {"rank": torch.distributed.get_rank(), "backend": torch.distributed.get_backend(),
           "position": tuple(mesh.axis_index(a) for a in mesh.axis_names)}
    t0 = time.perf_counter()
    for name, part in (("shuffle", lambda: _coll_shuffle(mesh, rep, join_path)),
                       ("wide_deep", lambda: _coll_wide_deep(mesh, rep)),
                       ("vocab", lambda: _coll_vocab(mesh, rep)),
                       ("moe", lambda: _coll_moe(mesh, rep))):
        t = time.perf_counter()
        if COLL_DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        part()
        rep[f"{name}_s"] = time.perf_counter() - t
        rep[f"{name}_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                  if COLL_DEVICE == "cuda" else 0.0)
    rep["ranks_s"] = time.perf_counter() - t0
    rep["launches"] = {m.__name__.rsplit(".", 1)[1]: m.launches
                       for m in (hash_mix, bucket_dedup, nested_join, scan_join)}
    return rep


def _traced_arms(wd_cap: int) -> dict:
    """Each phase-21 arm's collectives as the dry-run counts them: rank 0's
    program on a (2, 2) accounting mesh over a fake process group, fake
    args at the ranks' global shapes laid out by JAX's specs
    (``launch.dryrun.sharded_collectives``)."""
    import dataclasses

    import torch

    from repro_torch.configs import cells, mixtral_8x7b, qwen2_5_3b, wide_deep
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe, sharding, vocab_parallel
    from repro_torch.models.sharding import P

    acct = Mesh(("data", "model"), COLL_MESH)
    axes = acct.axis_names

    def arm(fn, shapes, specs):
        def build():
            with cells._Draw("cpu", True, 0, dynamic=True):
                args = tuple(torch.zeros(sh, dtype=dt) for sh, dt in shapes)
            return cells.CellSpec(name="arm", kind="arm", fn=fn, args=args, specs=specs)
        return build

    def shuffle(thi, tlo, hi, lo, v):
        blocks = [sharding.enter(x, P(axes)) for x in (thi, tlo, hi, lo, v)]
        return D.distributed_insert(sharding.current_mesh(), D.ShardedPTT(*blocks[:2]),
                                    *blocks[2:])[1]

    n_shards, i32 = acct.size, torch.int32
    builds = {"shuffle": arm(shuffle, [((n_shards, 1 << 22), i32), ((n_shards, 1 << 22), i32),
                                       ((COLL_KEYS,), i32), ((COLL_KEYS,), i32),
                                       ((COLL_KEYS,), torch.bool)], (P(axes),) * 5)}
    wd, B = wide_deep.config(), RECSYS_SHAPES["serve_p99"]
    for mode, c in {"plain": wd, "dedup": dataclasses.replace(wd, dedup_cap=wd_cap)}.items():
        builds[f"wide_deep_{mode}"] = lambda c=c: cells.recsys_serve_cell(c, acct, B,
                                                                           "serve_p99")
    q, n = qwen2_5_3b.config(), LM_TOKENS[0] * LM_TOKENS[1]
    ts, bf16 = sharding.token_spec(n, acct), torch.bfloat16
    builds["embed"] = arm(vocab_parallel.embed, [((q.vocab, q.d_model), bf16), ((n,), i32)],
                          (P("model", "data"), ts))
    builds["tied_logits"] = arm(vocab_parallel.tied_logits, [
        ((q.vocab, q.d_model), bf16), ((n, q.d_model), bf16)],
        (P("model", "data"), P(ts[0], None)))
    base = mixtral_8x7b.config().moe_cfg
    E, d, f = base.n_experts, base.d_model, base.d_ff
    for name, cfg in (("bf16", base), ("bf16_int8", base._replace(quantized_gather=True))):
        def layer(r, u, g, dn, x, cfg=cfg):
            return moe.forward({"router": {"w": r}, "up": u, "gate": g, "down": dn}, cfg, x)

        builds[f"moe_{name}"] = arm(layer, [
            ((d, E), torch.float32), ((E, d, f), bf16), ((E, d, f), bf16), ((E, f, d), bf16),
            ((n, d), bf16)], (P(None, None), *moe.SHARDED_SPECS.values(), P(ts[0], None)))
    return {name: dryrun.sharded_collectives(b, acct) for name, b in builds.items()}


def phase_collectives(join_path, pjtt_digest):
    """Phase 21: the collectives across ranks, 4 spawned ranks of a (2, 2)
    ``ProcessMesh`` on the one card (``launch.mesh.run_ranks``): the shuffle
    PTT and the PJTT/probe, Wide & Deep, the vocab-parallel table and the
    MoE arms at full width (each part's checks in its rank function)."""
    import gc
    import math

    import torch

    from repro_torch.launch.mesh import run_ranks, transport

    gc.collect()
    torch.cuda.empty_cache()
    world, cards = math.prod(COLL_MESH), torch.cuda.device_count()
    backend = transport(world, COLL_DEVICE)
    free = torch.cuda.mem_get_info()[0] if COLL_DEVICE == "cuda" else 0
    how = {"nccl": "one rank a card", "gloo": "ranks share a card: gloo on CUDA tensors"
           if COLL_DEVICE == "cuda" else "ranks on the CPU"}[backend]
    log(f"ranks: world size {world}, a {COLL_MESH} (data, model) mesh, {cards} card(s), "
        f"backend {backend} ({how}); {free / 1e9:.1f} GB free")
    t0 = time.perf_counter()
    reps = run_ranks(_collective_ranks, COLL_MESH, join_path, device=COLL_DEVICE,
                     timeout=COLL_TIMEOUT)
    wall = time.perf_counter() - t0
    r = reps[0]
    check([x["rank"] for x in reps] == list(range(world)), "ranks out of order")
    check(all(x["backend"] == backend for x in reps), f"a rank's backend is not {backend}")
    check([x["position"] for x in reps] == [(d, m) for d in range(COLL_MESH[0])
                                           for m in range(COLL_MESH[1])],
          f"rank positions {[x['position'] for x in reps]} are not row-major")
    log(f"ranks up and done in {wall:.1f} s wall (the arms {r['ranks_s']:.1f} s on rank 0: "
        f"shuffle {r['shuffle_s']:.1f}, Wide & Deep {r['wide_deep_s']:.1f}, vocab "
        f"{r['vocab_s']:.1f}, MoE {r['moe_s']:.1f}; the rest is spawning ranks and CUDA "
        f"contexts); rank 0's peaks GB: " + ", ".join(
            f"{p} {r[p + '_peak_gb']:.2f}" for p in ("shuffle", "wide_deep", "vocab", "moe")))
    check(not r["shuffle_ovf"] and r["n_new"] == r["n_distinct"],
          f"shuffle: is_new {r['n_new']} against {r['n_distinct']} distinct valid keys, "
          f"overflow {r['shuffle_ovf']}")
    check(r["shuffle_equal_stacked"], "shuffle: the ranks' tables, is_new or flag differ "
          "from the stacked arm's at n_shards = 4")
    log(f"shuffle over {world} ranks: {COLL_KEYS} mix64 keys (75% duplicates), 2^22 slots a "
        f"rank (tables {r['table_bytes'] / 1e6:.0f} MB, keys {COLL_KEYS * 8 / 1e6:.0f} MB): "
        f"insert {r['shuffle_ms']:.1f} ms wall (stacked arm on one process "
        f"{r['stacked_ms']:.1f} ms); is_new {r['n_new']} = {r['n_distinct']} distinct "
        f"(torch.unique); tables, is_new and flag equal the stacked arm's bit for bit")
    check(not r["pjtt_ovf"] and r["pjtt_equal_stacked"],
          "distributed PJTT over ranks: overflow, or differs from the stacked arm's")
    check(r["rowsets_sha256"] == pjtt_digest,
          "distributed PJTT over ranks: a child row's subjects differ from phase 14's")
    pr, cr, K = r["join_rows"]
    log(f"distributed PJTT over {world} ranks, 1M OJM join ({pr} parent rows, {cr} child "
        f"rows, K={K}): build {r['build_ms']:.1f} ms, probe {r['probe_ms']:.1f} ms wall; "
        f"skeys, ssubj, subjects and mask equal the stacked arm's; every row's subjects "
        f"equal phase 14's")
    for mode in ("plain", "dedup"):
        check(r[f"wd_{mode}_ok"], f"Wide & Deep over ranks, {mode}: logits differ from the "
              f"one-process forward (max {r[f'wd_{mode}_err']:.3g})")
    log(f"Wide & Deep over ranks at full width (table block {r['wd_table_block']} a rank), "
        f"serve_p99: forward p50 plain {r['wd_plain_ms']:.3f} ms, dedup_cap {r['wd_cap']} "
        f"{r['wd_dedup_ms']:.3f} ms ({WD_COLL_TIMED} warm forwards, wall); gathered logits "
        f"within rtol 1e-5, atol 1e-6 of the one-process forward (max |diff| plain "
        f"{r['wd_plain_err']:.3g}, dedup {r['wd_dedup_err']:.3g})")
    check(r["vocab_ok"], f"qwen2.5-3b vocab-parallel: embed not exact, or logits off (bf16 "
          f"{r['vocab_err_bf16']:.3g}, fp32 {r['vocab_err_fp32']:.3g})")
    log(f"qwen2.5-3b vocab-parallel over ranks (table block, logits block "
        f"{r['vocab_blocks']}): embed {r['embed_ms']:.2f} ms, tied_logits "
        f"{r['logits_ms']:.2f} ms wall (bf16); embed equal to the no-mesh take; logits max "
        f"|diff| bf16 {r['vocab_err_bf16']:.3g} (one bf16 step of the largest allowed), "
        f"fp32 {r['vocab_err_fp32']:.3g} (rtol 1e-5, atol 1e-6)")
    check(all(r[f"moe_{m}_finite"] for m in ("bf16", "bf16_int8", "bf16_nodrop", "fp32",
                                              "fp32_int8")),
          "MoE over ranks: a non-finite output or aux")
    check(r["moe_fp32_err"] <= MOE_RTOL and r["moe_fp32_int8_err"] <= MOE_RTOL,
          f"MoE over ranks, fp32: against _forward_local {r['moe_fp32_err']:.3g}, int8 "
          f"gather {r['moe_fp32_int8_err']:.3g} of the largest |y| (limit {MOE_RTOL})")
    check(abs(r["moe_aux"] - r["moe_aux_ref"]) <= MOE_RTOL * abs(r["moe_aux_ref"]),
          f"MoE aux {r['moe_aux']} against the data rows' mean {r['moe_aux_ref']}")
    check(r["moe_bf16_err"] <= BF16_NORM_TOL and r["moe_int8_vs_plain_bf16"] <= INT8_NORM_TOL,
          f"MoE bf16: {r['moe_bf16_err']:.3g} from _forward_local in bf16, int8 gather "
          f"{r['moe_int8_vs_plain_bf16']:.3g} from the plain gather")
    d, f, E, k = r["moe_dims"]
    log(f"mixtral-8x7b MoE layer over ranks (d {d}, f {f}, {E} experts, top-{k}, "
        f"{LM_TOKENS[0] * LM_TOKENS[1]} tokens): bf16 {r['moe_bf16_ms']:.2f} ms, int8 gather "
        f"{r['moe_bf16_int8_ms']:.2f} ms wall; fp32 at capacity_factor E/k = 4 (cap n+1, no "
        f"drop) within {r['moe_fp32_err']:.3g} of _forward_local's largest |y|, the int8 "
        f"gather within {r['moe_fp32_int8_err']:.3g} of _forward_local on its dequantized "
        f"weights; aux {r['moe_aux']:.6f} = the data rows' mean; bf16 at no drop "
        f"{r['moe_bf16_err']:.3g} from _forward_local in bf16, the int8 gather "
        f"{r['moe_int8_vs_plain_bf16']:.3g} from the plain one (normwise); at 1.25 the ranks drop "
        f"{r['moe_drop_sharded']} (token, expert) pairs (cap {r['moe_cap_sharded']} on "
        f"{r['moe_local_tokens']} local tokens), the local arm {r['moe_drop_local']} (cap "
        f"{r['moe_cap_local']})")
    t0 = time.perf_counter()
    traced = _traced_arms(r["wd_cap"])
    trace_s = time.perf_counter() - t0
    for name, want in traced.items():
        check(want.pop("replicated_for") == {}, f"{name}: the sharded trace replicated an op")
        for x in reps:
            got = x["live_collectives"][name]
            check(got == want, f"{name}: rank {x['rank']}'s live collectives {got} against "
                  f"the sharded trace's {want} on a {COLL_MESH} accounting mesh")
        log(f"collectives of {name}, live on each of the {world} ranks = traced on a "
            f"{COLL_MESH} accounting mesh: " + ", ".join(
                f"{k} {want['counts'][k]} x, {want['bytes_by_kind'][k]:,} B"
                for k in sorted(want["counts"])))
    log(f"the sharded traces of the {len(traced)} arms took {trace_s:.1f} s on the host")
    launches = {name: sum(x["launches"][name] for x in reps) for name in reps[0]["launches"]}
    check(not any(launches.values()), f"the collectives phase launched K1-K4: {launches}")
    log(f"launches of K1-K4 in the collectives phase (all ranks): {launches}")


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
        from repro_torch.kernels import bucket_dedup, hash_mix, nested_join, scan_join

        log("phase 1: device and toolchain")
        smi, rates = phase_device()
        log("phase 2: build the kernels")
        phase_build()
        log("phase 3: testbeds")
        beds = make_testbeds()
        log(f"phase 4: kernels against their plain versions on the card "
            f"(+{time.perf_counter() - T0:.1f} s)")
        kres = phase_kernels(beds, rates)
        log(f"phase 5: rdfize on the card (and the small tier on the CPU) "
            f"(+{time.perf_counter() - T0:.1f} s)")
        mods = {"hash_mix": hash_mix, "bucket_dedup": bucket_dedup, "nested_join": nested_join}
        launches, kgz_1m = phase_rdfize(beds, mods)
        log(f"phase 6: rdfize --emit kgz on the card (and the small tier on the CPU) "
            f"(+{time.perf_counter() - T0:.1f} s)")
        paths, kgz_launches = phase_kgz(beds, mods, kgz_1m)
        for name, n in kgz_launches.items():
            launches[name] += n
        stores = open_stores(paths)
        log(f"phase 7: K4 against its plain version on the card "
            f"(+{time.perf_counter() - T0:.1f} s)")
        kres["scan_join"] = phase_k4(stores, rates)
        log(f"phase 8: serving the bench classes on the card "
            f"(+{time.perf_counter() - T0:.1f} s)")
        launches["scan_join"] = phase_serve(stores)
        log(f"phase 9: the paper's figures on the card (+{time.perf_counter() - T0:.1f} s)")
        for name, n in phase_paper_figs(mods).items():
            launches[name] += n
        log(f"phase 10: a live store over the {LIVE_ROWS // 1000}K OJM store "
            f"(+{time.perf_counter() - T0:.1f} s)")
        phase_live(stores, paths)
        log(f"phase 11: sharded ingest and querying (+{time.perf_counter() - T0:.1f} s)")
        shard_launches, manifest = phase_shards(beds, mods, stores, paths)
        for name, n in shard_launches.items():
            launches[name] += n
        log(f"phase 12: the server and the shard coordinator (+{time.perf_counter() - T0:.1f} s)")
        launches["scan_join"] += phase_server(stores, manifest)
        log(f"phase 13: dedup_gather and Wide & Deep at full width "
            f"(+{time.perf_counter() - T0:.1f} s)")
        phase_recsys()
        log(f"phase 14: the distributed PTT/PJTT, {DIST_SHARDS} shards on the card "
            f"(+{time.perf_counter() - T0:.1f} s)")
        join_path, pjtt_digest = phase_distributed(beds)
        log(f"phase 15: the benchmark runner's dedup, live and shard sections "
            f"(+{time.perf_counter() - T0:.1f} s)")
        mods["scan_join"] = scan_join
        for name, n in phase_runner(mods).items():
            launches[name] += n
        log(f"phase 16: Wide & Deep training at full width "
            f"(+{time.perf_counter() - T0:.1f} s)")
        for name, n in phase_training(mods).items():
            launches[name] += n
        log(f"phase 17: the LM family at full width (+{time.perf_counter() - T0:.1f} s)")
        phase_lm(mods)
        log(f"phase 18: LM training at full width (+{time.perf_counter() - T0:.1f} s)")
        phase_lm_train(mods)
        log(f"phase 19: GNN training at full width (+{time.perf_counter() - T0:.1f} s)")
        phase_gnn(mods)
        log(f"phase 20: the dry-run against real runs (+{time.perf_counter() - T0:.1f} s)")
        phase_dryrun(mods)
        log(f"phase 21: collectives across ranks, {COLL_MESH} ranks on the card "
            f"(+{time.perf_counter() - T0:.1f} s)")
        phase_collectives(join_path, pjtt_digest)
        log(f"phases done (+{time.perf_counter() - T0:.1f} s)")
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

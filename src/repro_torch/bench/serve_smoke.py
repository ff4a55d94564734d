"""End-to-end serving smoke of the port, the counterpart of
``scripts/serve_smoke.sh``: the same steps and assertions against
``repro_torch.launch.{rdfize,serve}`` and ``repro_torch.api``.

A tiny SOM testbed (200 rows) is rdfized to a ``.kgz``; a query server on it
(port 0: the kernel picks one, parsed from the server's ``[serve] listening
on`` line) answers client queries over the wire (plain, UNION, GROUP
BY-COUNT), then the live round trip (insert, query, delete, query, compact,
query) and the metrics op; at shutdown the server writes a Chrome trace.
Every answer is checked; the exit code is non-zero on the first failure.

    PYTHONPATH=src python -m repro_torch.bench.serve_smoke [--port N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GN = "<http://repro.org/vocab/gene_name>"
AN = "<http://repro.org/vocab/accession_number>"
_LISTENING = re.compile(r"\[serve\] listening on [^ :]*:(\d+)")


class SmokeError(AssertionError):
    pass


def check(cond, what) -> None:
    if not cond:
        raise SmokeError(what)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def run_module(module: str, *args: str, with_stderr: bool = False) -> str:
    """``python -m module args`` to its end -> its standard output (followed
    by its standard error with ``with_stderr``)."""
    p = subprocess.run([sys.executable, "-m", module, *args], env=_env(),
                       capture_output=True, text=True)
    if p.returncode:
        raise SmokeError(f"{module} {' '.join(args)} exited {p.returncode}:\n"
                         f"{p.stdout}\n{p.stderr}")
    return p.stdout + p.stderr if with_stderr else p.stdout


def start_module(module: str, *args: str, log: str) -> subprocess.Popen:
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", module, *args], env=_env(),
                                stdout=subprocess.DEVNULL, stderr=f)


def wait_for_port(log: str, proc: subprocess.Popen, timeout_s: float = 120.0) -> int:
    """The port a server announced in its log (``[serve] listening on
    host:port``)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with open(log) as f:
            m = _LISTENING.search(f.read())
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    with open(log) as f:
        raise SmokeError(f"the server never announced a listening port; log:\n{f.read()}")


def stop(proc: subprocess.Popen | None) -> None:
    if proc is not None and proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def make_testbed(work: str) -> None:
    """The smoke's testbed: 200 SOM rows, 50% duplicates, 2 maps, seed 3."""
    from repro_torch.rml import generator, serializer

    tb = generator.make_testbed("SOM", 200, 0.5, n_poms=2, seed=3)
    tb.write(work)
    serializer.write_turtle(tb.doc, os.path.join(work, "mapping.ttl"))


def rdfize(work: str, out: str, device: str, *extra: str) -> None:
    run_module("repro_torch.launch.rdfize", "--mapping", os.path.join(work, "mapping.ttl"),
               "--data-root", work, "--out", out, "--emit", "kgz", "--device", device, *extra)


def _client(port: int, *args: str) -> dict:
    return json.loads(run_module("repro_torch.launch.serve", "--connect", f"127.0.0.1:{port}",
                                 *args, "--retry-s", "30"))


def check_query(port: int) -> None:
    resp = _client(port, "--query", f"SELECT * WHERE {{ ?m {GN} ?g }} LIMIT 3")
    check(resp.get("vars") == ["?m", "?g"], resp)
    check(resp.get("n_total", 0) > 0 and len(resp["rows"]) == 3, resp)
    m, g = resp["rows"][0]
    check(m.startswith("<http://repro.org/") and g.startswith('"'), resp)
    print(f"serve smoke OK: {resp['n_total']} solutions, batch={resp['batch_size']}, "
          f"{resp['latency_ms']}ms", flush=True)


def check_algebra(port: int) -> None:
    base = _client(port, "--query", f"SELECT * WHERE {{ ?m {GN} ?g }}")
    union = _client(port, "--query", f"SELECT * WHERE {{ {{ ?m {GN} ?x }} UNION {{ ?m {AN} ?x }} }}")
    accn = _client(port, "--query", f"SELECT * WHERE {{ ?m {AN} ?x }}")
    count = _client(port, "--query", f"SELECT ?g (COUNT(?m) AS ?n) WHERE {{ ?m {GN} ?g }} "
                    "GROUP BY ?g ORDER BY DESC(?n)")
    # UNION = bag union of the two single-predicate queries
    check(union["vars"] == ["?m", "?x"], union)
    check(union["n_total"] == base["n_total"] + accn["n_total"],
          (union["n_total"], base["n_total"], accn["n_total"]))
    check(all(m.startswith("<") and x.startswith('"') for m, x in union["rows"]),
          union["rows"][:3])
    # GROUP BY-COUNT: integer cells flagged via agg_vars, counts sum to the
    # plain query's solution count, sorted descending
    check(count["vars"] == ["?g", "?n"] and count["agg_vars"] == ["?n"], count)
    ns = [n for _, n in count["rows"]]
    check(all(isinstance(n, int) and n >= 1 for n in ns), ns[:5])
    check(ns == sorted(ns, reverse=True), ns[:10])
    check(count["n_total"] == len(count["rows"]), count["n_total"])
    check(sum(ns) == base["n_total"], (sum(ns), base["n_total"]))
    print(f"algebra smoke OK: union={union['n_total']} rows, {count['n_total']} gene groups "
          f"summing to {sum(ns)}", flush=True)


def check_live(port: int) -> None:
    """insert -> query -> delete a base triple (tombstoned until compaction)
    -> compact (persisted to the .kgz) -> query, through ``api.connect``."""
    from repro_torch import api

    q = f"SELECT * WHERE {{ ?m {GN} ?g }}"
    with api.connect(f"127.0.0.1:{port}", retry_s=30) as c:
        before = c.query(q)
        n0 = before.n_total
        try:  # typed errors surface over the wire with their code
            c.query("SELECT nonsense")
            raise SmokeError("bad query text must raise")
        except api.QueryParseError as e:
            check(e.code == "parse", e.code)
        r = c.insert([["<http://smoke/x1>", GN, '"live-one"'],
                      ["<http://smoke/x2>", GN, '"live-two"']])
        check(r["inserted"] == 2 and r["generation"] >= 1, r)
        mid = c.query(q)
        check(mid.n_total == n0 + 2, (mid.n_total, n0))
        m, g = before.rows[0]
        d = c.delete([[m, GN, g]])
        check((d["deleted"], d["tombstoned"]) == (1, 1), d)
        check(d["delta_fraction"] > 0, d)
        after = c.query(q)
        check(after.n_total == n0 + 1, (after.n_total, n0))
        rc = c.compact()
        check(rc["compacted"] and rc["persisted"], rc)
        check(rc["delta_fraction"] == 0 and rc["n_total"] >= n0 + 1, rc)
        final = c.query(q)
        check(final.n_total == n0 + 1, (final.n_total, n0))
        met = c.metrics()["metrics"]
        cnt = met["counters"]
        check(cnt["live.inserts"] == 2, cnt)
        check(cnt["live.deletes"] == 1 and cnt["live.tombstone_hits"] == 1, cnt)
        check(cnt["live.compactions"] == 1, cnt)
        check(met["histograms"]["live.compact_ms"]["count"] == 1, met["histograms"])
        check(met["gauges"]["live.delta_fraction"] == 0.0, met["gauges"])
    print(f"live smoke OK: {n0} -> insert 2 -> tombstone 1 -> compact({rc['compact_ms']}ms, "
          f"persisted) -> {final.n_total}", flush=True)


def check_metrics(port: int) -> None:
    m = _client(port, "--metrics")
    hists, counters = m["metrics"]["histograms"], m["metrics"]["counters"]
    req = hists["serve.request_ms"]
    check(req["count"] >= 5 and req["p50"] is not None and req["p99"] is not None, req)
    # every request recorded a queue wait and an execute time
    check(hists["serve.queue_wait_ms"]["count"] == req["count"], hists["serve.queue_wait_ms"])
    check(hists["serve.exec_ms"]["count"] >= 1, hists["serve.exec_ms"])
    check(counters["serve.queries"] == req["count"], counters)
    sig = [k for k in hists if k.startswith("serve.exec_ms.sig=")]
    check(sig and m["signatures"], (sig, m["signatures"]))
    print(f"metrics smoke OK: {req['count']} requests, queue p50="
          f"{hists['serve.queue_wait_ms']['p50']:.3f}ms, exec p50="
          f"{hists['serve.exec_ms']['p50']:.3f}ms, {len(sig)} signatures", flush=True)


def check_trace(path: str) -> None:
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    check(isinstance(evs, list) and evs, "empty trace")
    names = {e["name"] for e in evs}
    check({"queue_wait", "dispatch"} <= names, names)
    for e in evs:
        check(e["ph"] == "X" and "ts" in e and "dur" in e, e)
    print(f"trace smoke OK: {len(evs)} events, spans={sorted(names)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.serve_smoke")
    ap.add_argument("--port", type=int, default=0, help="0: the kernel picks a free port")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    work = tempfile.mkdtemp(prefix="serve_smoke_")
    server = None
    try:
        make_testbed(work)
        kgz = os.path.join(work, "kg.kgz")
        rdfize(work, kgz, args.device)
        trace = os.path.join(work, "trace.json")
        log = os.path.join(work, "server.log")
        server = start_module("repro_torch.launch.serve", "--kg", kgz, "--port", str(args.port),
                              "--device", args.device, "--trace", trace, log=log)
        port = wait_for_port(log, server)
        print(f"[smoke] server is up on port {port}", flush=True)
        check_query(port)
        check_algebra(port)
        check_live(port)
        check_metrics(port)
        # shutdown writes the Chrome trace
        stop(server)
        server = None
        check_trace(trace)
    except SmokeError as e:
        print(f"serve smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        stop(server)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``repro_torch.bench.serve_smoke`` (the port's ``scripts/serve_smoke.sh``)
end to end on the CPU: rdfize, a query server on port 0, the wire queries,
the live round trip, the metrics op and the trace, each answer checked."""

from repro_torch.bench import serve_smoke


def test_serve_smoke_passes_on_the_cpu():
    assert serve_smoke.main(["--device", "cpu"]) == 0

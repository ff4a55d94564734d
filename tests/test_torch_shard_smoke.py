"""``repro_torch.bench.shard_smoke`` (the port's ``scripts/shard_smoke.sh``)
end to end on the CPU: 2-shard ingest with 2 spawned workers, the shard
session against the unsharded store, the coordinator server and the query
CLI over the manifest."""

from repro_torch.bench import shard_smoke


def test_shard_smoke_passes_on_the_cpu():
    assert shard_smoke.main(["--device", "cpu"]) == 0

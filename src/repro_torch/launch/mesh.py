"""Mesh definitions: JAX's production layouts, the cards at hand, and
meshes of ranks.

The counterpart of ``repro.launch.mesh``.  A ``Mesh`` here is a named grid
of devices used for accounting: the dry-run (``launch.dryrun``) reads
per-device shapes off it through ``models.sharding.local_shape``.  A
``ProcessMesh`` is a grid of ranks in any of those layouts, one process
each, over ``torch.distributed`` process groups: the shard_map arms run on
it (``models.sharding.set_mesh``), and ``run_ranks`` spawns its processes.
``fake_process_mesh`` brings up rank 0 of an accounting mesh over a fake
process group in the current process: the dry-run traces each cell's
per-device program on it and counts its collectives.
Both have ``axis_names``, ``shape`` and ``size``, so ``local_shape`` reads
either.  Importing this module touches no device and starts no process.

The transport is chosen from the layout before any process group starts:
one rank a card runs NCCL; ranks that share a card run gloo on CUDA
tensors (the tensors stay on the card, and gloo stages each exchange
through the host); ranks on the CPU run gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import math
import os
import signal
import tempfile
import time
import traceback

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices (JAX's ``mesh.devices.size``)."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production layouts as accounting meshes: 16x16 = 256 devices
    a pod, ``("data", "model")``; ``multi_pod`` adds the 2-pod axis (512,
    ``("pod", "data", "model")``).  No cards stand behind them: the
    dry-run divides a traced cell over them and reads per-device shapes
    off their specs."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(n_devices: int | None = None, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over ``n_devices``, by default the cards
    ``torch.cuda.device_count()`` finds (raises when there is none and no
    ``n_devices`` is given)."""
    if n_devices is None:
        import torch

        n_devices = torch.cuda.device_count()
        if n_devices == 0:
            raise RuntimeError("no CUDA card: pass n_devices for a mesh without one")
    return Mesh(("data", "model"), (n_devices // model, model))


AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ProcessMesh(Mesh):
    """This rank's view of a mesh of ranks (one process each) over the
    default process group, which must already be up (``run_ranks`` starts
    it, ``fake_process_mesh`` starts a fake one); ``init`` builds it.  Any
    of JAX's layouts: ``("data", "model")`` or ``("pod", "data",
    "model")``.  Ranks are numbered row-major over the axes, as JAX
    linearizes a device's mesh position: the rank at ``(d, m)`` of a
    ``(data, model)`` mesh is ``d * sizes[1] + m``."""

    device_mesh: object = dataclasses.field(default=None, compare=False, repr=False)
    subs: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def init(cls, sizes, device: str = "cuda", axes=AXES) -> ProcessMesh:
        """This rank's mesh of ``sizes`` ranks, one size an axis of ``axes``,
        on ``device``."""
        from torch.distributed.device_mesh import init_device_mesh

        sizes, axes = tuple(sizes), tuple(axes)
        if len(sizes) != len(axes):
            raise ValueError(f"{len(sizes)} sizes for the {len(axes)} axes {axes}")
        return cls(axes, sizes, init_device_mesh(device, sizes, mesh_dim_names=axes))

    def axis_index(self, name: str) -> int:
        """This rank's index along axis ``name``."""
        return self.device_mesh.get_local_rank(name)

    def _names(self, axes) -> tuple:
        """``axes`` (a name, or a tuple of names in mesh order) as a tuple."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in names if a in self.axis_names]
        if not names or len(order) != len(names) or order != sorted(set(order)):
            raise ValueError(f"axes {axes!r}: one or more of {self.axis_names}, in mesh order")
        return names

    def axis_size(self, axes) -> int:
        """The ranks along ``axes`` (a name, or a tuple of names)."""
        return math.prod(self.shape[a] for a in self._names(axes))

    def sub_mesh(self, axes):
        """The ``DeviceMesh`` of ``axes``: one axis's, or their product
        flattened into one dim (group ranks in axis order either way)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        names = self._names(axes)
        if names not in self.subs:
            # the mesh's rank tables are real tensors, also inside a fake trace
            with unset_fake_temporarily():
                sub = self.device_mesh[names[0] if len(names) == 1 else names]
                self.subs[names] = sub if len(names) == 1 else sub._flatten("_".join(names))
        return self.subs[names]

    def group(self, axes):
        """The process group of ``axes``: the world for the whole mesh, one
        axis's group, or the flattened group of several."""
        import torch.distributed as dist

        names = self._names(axes)
        if names == self.axis_names:
            return dist.group.WORLD
        return self.sub_mesh(names).get_group()


def _fake_backend():
    """The in-process fake transport's store, or the reason it is missing."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # the fake backend ships in torch's testing package
        raise RuntimeError(f"the fake process group is not available in this torch: {e}") from e
    return FakeStore


@contextlib.contextmanager
def fake_process_mesh(mesh: Mesh):
    """Rank 0's ``ProcessMesh`` of ``mesh``'s layout over a fake process
    group of ``mesh.size`` ranks in this process, for the ``with`` block:
    the counterpart of JAX's forced host devices.  Collectives on it move
    nothing; under ``FakeTensorMode`` they allocate nothing.  A process
    holds one default group, so this raises when one is already up."""
    import torch.distributed as dist

    store = _fake_backend()
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process: the fake "
                           "accounting group needs a process of its own")
    dist.init_process_group("fake", store=store(), rank=0, world_size=mesh.size)
    try:
        yield ProcessMesh.init(mesh.sizes, "cpu", axes=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def transport(world: int, device: str) -> str:
    """The process-group backend for ``world`` ranks on ``device``: NCCL
    when every rank has a card of its own, else gloo."""
    if device == "cpu":
        return "gloo"
    import torch

    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _rank_main(rank, fn, args, sizes, device, backend, store_path, out_dir, timeout):
    import torch
    import torch.distributed as dist

    world = math.prod(sizes)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(ProcessMesh.init(sizes, device), *args)
    except BaseException:
        # the first rank to fail says why; its peers fail after it in a collective
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _first_failure(out_dir: str, procs) -> str | None:
    """Why the ranks failed: a rank that exited with no traceback (its peers
    fail after it in a collective), else the first traceback written."""
    ended = (0, None, -signal.SIGTERM, -signal.SIGKILL)  # the last two: ended by the join
    for r, p in enumerate(procs):
        if p.exitcode not in ended and not os.path.exists(os.path.join(out_dir, f"rank{r}.err")):
            return f"rank{r} exited with code {p.exitcode} and no traceback"
    errs = sorted((e.stat().st_mtime_ns, e.name, e.path) for e in os.scandir(out_dir)
                  if e.name.endswith(".err"))
    if not errs:
        return None
    with open(errs[0][2]) as f:
        return f"{errs[0][1].removesuffix('.err')} failed first:\n{f.read()}"


def run_ranks(fn, sizes, *args, device: str = "cuda", timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on a ``ProcessMesh`` of ``sizes`` (data,
    model) ranks, each a spawned process, and return their results in rank
    order (``fn`` and ``args`` must pickle; results are saved with
    ``torch.save``).  The group meets through a ``FileStore`` in a fresh
    temporary directory, so concurrent runs never share a port, and each
    collective gives up after ``timeout`` seconds.  When a rank raises or
    dies, the others are terminated and this raises; past ``timeout`` in
    all, every rank is terminated and this raises ``TimeoutError``."""
    import torch
    import torch.multiprocessing as mp

    sizes = tuple(sizes)
    world = math.prod(sizes)
    backend = transport(world, device)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    log.info("run_ranks: %d ranks %s on %s, %d card(s), backend %s", world, sizes, device,
             cards, backend)
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, args, sizes, device, backend, os.path.join(tmp, "store"), tmp, timeout))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    for p in ctx.processes:
                        p.join()
                    raise TimeoutError(f"{world} ranks still running after {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            first = _first_failure(tmp, ctx.processes)
            if first is None:
                raise
            raise RuntimeError(first) from e
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]

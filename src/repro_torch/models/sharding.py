"""Partition specs, the per-device shapes they give, and the mesh of ranks.

The counterpart of ``repro.models.sharding``.  ``P`` names the mesh axes
that split each dim of a tensor (JAX's ``PartitionSpec``, read as a
tuple), and ``local_shape`` gives the shape one device holds, by JAX's rule
(``NamedSharding(mesh, spec).shard_shape``): a dim split ``w`` ways holds
``dim / w``, and a dim that ``w`` does not divide is an error.  The
dry-run reads these shapes off accounting meshes (``launch.mesh.Mesh``).

A ``launch.mesh.ProcessMesh`` is a mesh of ranks, one process each.
``set_mesh`` makes one active for the code it wraps, as ``jax.set_mesh``
does, and ``active_axes`` then names its axes: the models' shard_map arms
(``vocab_parallel``, ``recsys``, ``moe``) take over when ``data`` and
``model`` are active.  Each arm is SPMD code that runs on every rank: its
inputs and outputs are the blocks JAX's ``shard_map`` body sees, this
rank's slice by the in-specs (``local_block``) and its slice of the
out-specs (``gather_block`` assembles the global array on every rank).
The named-axis collectives below are the ``jax.lax`` calls those bodies
make, over the mesh's process groups: ``all_to_all`` (JAX's
``all_to_all(x, axes, 0, 0)``), ``psum``, ``pmax``, ``pmean``, the tiled
``all_gather`` and ``axis_index``.  A tuple of axes is the whole mesh in
axis order, whose ranks are numbered row-major as JAX linearizes a mesh
position; bool tensors travel as ``uint8``.  Each collective has JAX's
transpose as its backward (``psum``: a psum; ``all_gather``: a
reduce-scatter; ``all_to_all``: an all-to-all), so gradients flow through
an arm.  Outside a sharded trace there is no GSPMD: ``constrain`` is the
identity, and code outside the arms runs on each rank's own data-parallel
block.

The sharded trace (``sharded_trace``) is GSPMD's counterpart, by DTensor
(``torch.distributed.tensor``), for counting a cell's collectives on an
accounting mesh (``launch.dryrun``): over rank 0 of a fake process group
(``launch.mesh.fake_process_mesh``) a cell's args become DTensors laid out
by their specs (``distribute``: a dim split over a tuple of axes is
``Shard`` on each, in mesh order), every op propagates by DTensor's rules
(plain tensors the code makes count as replicated), ``constrain``
redistributes to its spec, and the arms enter on their in-specs' local
blocks (``enter``) and leave by their out-specs (``leave``), as
``shard_map`` does.  Where GSPMD partitions an op otherwise than DTensor
would, the trace partitions it as GSPMD does, and the model code carries
only JAX's own constraints: a torch-function mode (``_Partitioner``) takes
the products with a weight (FSDP's gather at use, once a trace in a
program without gradients, and in the backward, the row-parallel sums
reduced where made, the backward's transposed dots laid out as the
forward's operand whose cotangent they make), two-operand ``einsum`` on
each rank's blocks, and ``logsumexp``/``gather`` over a split vocabulary;
DTensor op handlers take views, ``stack``, gathers and scatters by
indices, the softmax over a length-split cache (the flash-decoding
combine), the cache's slot reads and writes, and one position sliced
from a split dim (a collective-permute).  A constraint whose axes do not
divide a dim pads it, as GSPMD does (rank 0 holds the padded block), and
a batch of waves too small for the data axes is laid out as GSPMD lays
it (``_block_view``).  A loop's
``carry`` keeps its layout in the backward, as a ``lax.scan`` carry does,
and an arm's gather of a block already gathered in the step is not issued
again, as XLA's CSE merges it.  The handlers act alike in every torch
version, whose own rules for these ops differ.  An op DTensor has no rule
for runs on its inputs replicated (``Replicated``), and the trace names
it.

GSPMD may split one mesh axis over two dims of a tensor (a dim of ``H *
D`` split ``k`` ways, viewed as ``(H, D)``: ``gcd(H, k)`` ways on ``H``,
the rest on ``D``), which DTensor cannot place on one mesh dim.  The
trace's mesh factors ``model`` into its primes (``launch.mesh``), so a
split over part of the axis is a placement on some of its factors: a view
keeps such a tiling (``_tiled_view``), DTensor's moves and sharding
propagation run as on the unfactored mesh where each axis's factors agree
(the same collectives as there) and otherwise move a tiling by the one
collective XLA issues for it (``_tiled_move``); a slice of a split dim and
its transpose move blocks by collective-permutes, a concatenate by
all-to-alls.  A ``lax.scan`` loop's later steps (``scan``) repeat its
first step's collectives, which JAX counts once.  XLA removes the code no
output reads, and the trace leaves its collectives uncounted: a forward
op none of whose results the backward pass or a result outside the graph
reads, and that op again in a rematerialized region's recomputation
(``_Liveness``).

JAX's version shims (``repro.compat``: ``shard_map``, ``pallas_native``,
``compat_make_mesh``) have no counterpart: they wrap jax APIs that differ
across jax versions.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode


def _canonical(part):
    """JAX's reading of an entry: a list is a tuple, a one-name tuple its
    name, an empty tuple ``None``."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return part[0] if len(part) == 1 else (part or None)
    return part


class P:
    """A partition spec: one entry a dim, each an axis name, a tuple of axis
    names (the dim split over their product) or ``None`` (whole), read as
    JAX reads them (``("data",)`` is ``"data"``).  Missing trailing entries
    are ``None``.  Equal to a ``P`` or a tuple of the same
    entries; not itself a tuple, so a pytree holds it as a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(_canonical(p) for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self.parts == other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self.parts)) + ")"


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``launch.mesh.ProcessMesh``) the active mesh for
    the ``with`` block, as ``jax.set_mesh`` does."""
    if not callable(getattr(mesh, "group", None)):
        raise TypeError(f"set_mesh takes a ProcessMesh (a mesh of ranks), got {mesh!r}")
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def current_mesh():
    """The active ``ProcessMesh``, or ``None``."""
    return _ACTIVE.get()


def active_axes() -> tuple:
    """The axes of the active mesh; empty when none is active."""
    mesh = current_mesh()
    return tuple(mesh.axis_names) if mesh is not None else ()


def arms_active() -> bool:
    """Whether a mesh with ``data`` and ``model`` axes is active: the
    shard_map arms take over then."""
    axes = active_axes()
    return "data" in axes and "model" in axes


def constrain(x, spec: P):
    """JAX's sharding constraint: in a sharded trace, ``x`` redistributed to
    ``spec`` (axes the mesh lacks dropped, as JAX drops them; a dim its
    axes do not divide is split all the same, padded as GSPMD pads it: a
    rank holds the ceiling of its share, the first ranks the rows, so the
    block the trace counts, rank 0's, is the padded one).  Otherwise the
    identity: outside the explicit arms every rank computes on its own
    block."""
    if not is_distributed(x):
        return x
    mesh = _SHARDED.get()
    spec = _present(spec, mesh)
    if any(x.shape[d] % math.prod(mesh.shape[a] for a in _axes(part))
           for d, part in enumerate(spec)):
        _PADS.get()["seen"] = True  # DTensor keeps padded splits from here on
    return _Constrain.apply(x, placements(spec, mesh))


class _Constrain(torch.autograd.Function):
    """A constraint and its transpose: the cotangent is constrained to the
    same layout (JAX's transpose of ``with_sharding_constraint``), where
    DTensor's redistribute would return it to the input's layout."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        return _redistribute(x, target)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.target), None


# a sharded trace's step of a loop JAX writes as lax.scan: whether its
# collectives repeat the first step's
_REPEAT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_repeat", default=False)


def scan(steps):
    """The steps of a loop JAX writes as ``lax.scan`` (``for i in
    scan(range(n))``): in a sharded trace each step after the first
    repeats the first one's collectives (``repeating``), as XLA's while
    loop holds its body once and JAX's ``collective_bytes`` reads it once;
    the backward pass's steps likewise, from the last step's ``carry`` to
    the first's.  Otherwise the steps as they are."""
    if _SHARDED.get() is None:
        yield from steps
        return
    before = _REPEAT.get()
    try:
        for i, step in enumerate(steps):
            _REPEAT.set(before or i > 0)
            yield step
    finally:
        _REPEAT.set(before)


def repeating() -> bool:
    """Whether the collectives being issued repeat a loop's first step
    (``scan``): the dry-run does not count them again."""
    return _REPEAT.get()


def carry(*xs):
    """A loop's carry at the end of a step, as JAX's ``lax.scan`` carries
    it: in a sharded trace each DTensor's cotangent is split as the tensor
    is (XLA's while loop holds one layout for its carry, and its
    transposed loop's carry takes that split, resharding a cotangent once
    where the loop starts; on an axis the tensor is whole over, the
    cotangent stays as it lies); otherwise the tensors as they are."""
    return tuple(_Carry.apply(x) if is_distributed(x) else x for x in xs)


class _Carry(torch.autograd.Function):
    """The carry's identity; its backward starts the transposed loop's step
    (``scan``: a later step's repeats the first's collectives)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements, ctx.repeat = x.placements, _REPEAT.get()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _redistribute(g, [p if p.is_shard() else q
                              for p, q in zip(ctx.placements, g.placements)])
        _REPEAT.set(ctx.repeat)
        return g


def _axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape one device of ``mesh`` holds of a ``shape`` tensor laid out
    by ``spec`` (JAX's ``shard_shape``); raises ``ValueError`` where JAX
    does: a dim the product of its axes does not divide, a spec longer than
    the shape, or an axis the mesh lacks."""
    shape, parts = tuple(shape), tuple(spec)
    if len(parts) > len(shape):
        raise ValueError(f"{spec} has {len(parts)} entries for a rank-{len(shape)} shape "
                         f"{shape}")
    sizes = dict(mesh.shape)
    out = []
    for dim, (n, part) in enumerate(zip(shape, parts + (None,) * (len(shape) - len(parts)))):
        names = _axes(part)
        missing = [a for a in names if a not in sizes]
        if missing:
            raise ValueError(f"{spec} names axes {missing} the mesh {tuple(sizes)} lacks")
        ways = math.prod(sizes[a] for a in names)
        q, r = divmod(n, ways)
        if r:
            raise ValueError(f"{spec} splits axis {dim} of {shape} {ways} ways, which does "
                             f"not divide {n}")
        out.append(q)
    return tuple(out)


def token_spec(n: int, mesh) -> P:
    """JAX's layout of a flattened stream of ``n`` tokens (ids, rows) in the
    shard_map arms: split over the data-parallel axes (``pod``, ``data``)
    when their product divides ``n``, else replicated (tiny decode and
    retrieval batches)."""
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return P(dp) if n % math.prod(mesh.shape[a] for a in dp) == 0 else P(None)


def _position(mesh, names: tuple) -> int:
    """This rank's position along ``names``, row-major in their order."""
    idx = 0
    for a in names:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx


def local_block(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` laid out by ``spec``
    (the slice a shard_map body sees; shapes by ``local_shape``)."""
    shape = local_shape(x.shape, spec, mesh)
    for dim, part in enumerate(spec):
        names = _axes(part)
        if names:
            x = x.narrow(dim, _position(mesh, names) * shape[dim], shape[dim])
    return x.contiguous()


def gather_block(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """``local_block``'s inverse: every rank's ``spec`` block -> the global
    tensor, on every rank (a tiled ``all_gather`` a split dim)."""
    for dim, part in enumerate(spec):
        names = _axes(part)
        if names:
            x = all_gather(x, names, axis=dim, mesh=mesh)
    return x


# -- named-axis collectives: jax.lax's, over a ProcessMesh's groups ---------

def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("a collective needs a ProcessMesh: pass one or use set_mesh")
    return mesh


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` fit for the transport: contiguous, bool as uint8."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()


def _unwire(y: torch.Tensor, dtype) -> torch.Tensor:
    return y.to(torch.bool) if dtype == torch.bool else y


def axis_index(name: str, mesh=None) -> int:
    """This rank's index along axis ``name`` (``jax.lax.axis_index``)."""
    return _mesh(mesh).axis_index(name)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    src = _wire(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _unwire(out, x.dtype)


def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    y = _wire(x).clone()  # all_reduce works in place
    dist.all_reduce(y, op=op, group=group)
    return _unwire(y, x.dtype)


# all_gather_into_tensor is all_gather_single on newer torch (same arguments)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather0(x: torch.Tensor, ways: int, group) -> torch.Tensor:
    src = _wire(x)
    out = src.new_empty((ways * src.shape[0], *src.shape[1:]))
    _gather_into(out, src, group=group)
    return _unwire(out, x.dtype)


def _scatter0(x: torch.Tensor, ways: int, group) -> torch.Tensor:
    out = x.new_empty((x.shape[0] // ways, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


_ISSUED: contextvars.ContextVar = contextvars.ContextVar("repro_torch_issued", default=None)


def _once(tag: tuple, x: torch.Tensor, issue, fresh: bool = True):
    """``issue()``, a collective (or a pure function) of ``x``, as XLA's CSE
    leaves it in a compiled step: in a sharded trace one of the same
    ``tag`` on the same value (the same view of one storage, unwritten
    since) is issued once and its result reused, a copy where ``fresh`` (a
    weight's block gathered by an arm in every microbatch and again in its
    rematerialized forward); otherwise issued."""
    memo = _ISSUED.get()
    if memo is None:
        return issue()
    key = (tag, x.untyped_storage()._cdata, x.storage_offset(), tuple(x.shape), x.stride(),
           x.dtype, x._version)
    live, at = issuing()
    if key not in memo:
        memo[key] = (x, issue(), at)  # x held: its storage is not freed and reused
    elif live is not None:  # a later call reads the first one's collectives
        live.reused.append((memo[key][2], at))
    return memo[key][1].clone() if fresh else memo[key][1]


def once(fn, x: torch.Tensor, *args):
    """``fn(x, *args)`` for a pure ``fn``: in a sharded trace its first
    result for a value of ``x``, detached, is reused (``_once``), as XLA's
    CSE keeps one copy of a pure computation in a compiled step (so a
    collective of it is issued once too); ``fn`` still runs, so a
    rematerialized forward records what the first did.  Otherwise
    ``fn(x, *args)``."""
    from torch.utils._pytree import tree_map

    out = fn(x, *args)
    if _ISSUED.get() is None:
        return out
    return _once(("once", fn, args), x, lambda: tree_map(torch.Tensor.detach, out),
                 fresh=False)


# a shard_map body's own collective (jax.lax's): XLA keeps it over a group
# of one rank, where GSPMD makes none
_EXPLICIT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_explicit", default=False)


def explicit() -> bool:
    """Whether the collective being issued is a named-axis one of an arm
    (``psum``, ``all_gather``, ... and their transposes): the dry-run
    counts it over a one-rank group too, as XLA keeps a shard_map's
    collective there (GSPMD issues none over one rank)."""
    return _EXPLICIT.get()


@contextlib.contextmanager
def _named():
    token = _EXPLICIT.set(True)
    try:
        yield
    finally:
        _EXPLICIT.reset(token)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.named = group, explicit()
        return _reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        with _named() if ctx.named else contextlib.nullcontext():
            return _reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        with _named():
            return _a2a(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The tiled gather along axis 0; its transpose is a reduce-scatter.  In
    a sharded trace a gather of a block already gathered is not issued
    again (``_once``)."""

    @staticmethod
    def forward(ctx, x, ways, group):
        ctx.ways, ctx.group = ways, group
        return _once(("all-gather", ways, group), x, lambda: _gather0(x, ways, group))

    @staticmethod
    def backward(ctx, g):
        with _named():
            return _scatter0(g, ctx.ways, ctx.group), None, None


def all_to_all(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, 0, 0)``: axis 0 of ``x`` in as many
    equal chunks as ``axes`` has ranks, chunk ``k`` to rank ``k``; the
    chunks received, in source order."""
    with _named():
        return _AllToAll.apply(x, _mesh(mesh).group(axes))


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.psum``: the sum over the ranks of ``axes``, on each."""
    with _named():
        return _Psum.apply(x, _mesh(mesh).group(axes))


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.pmax``: the largest over the ranks of ``axes``, on each."""
    with _named():
        return _reduce(x, dist.ReduceOp.MAX, _mesh(mesh).group(axes))


def pmean(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.pmean``: ``psum`` over the ranks' count."""
    mesh = _mesh(mesh)
    return psum(x, axes, mesh) / mesh.axis_size(axes)


def all_gather(x: torch.Tensor, axes, axis: int = 0, mesh=None) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=axis, tiled=True)``: the ranks'
    ``x`` concatenated along ``axis`` in their order along ``axes``."""
    mesh = _mesh(mesh)
    with _named():
        out = _AllGather.apply(x.movedim(axis, 0), mesh.axis_size(axes), mesh.group(axes))
    return out.movedim(0, axis).contiguous()


# -- the sharded trace: GSPMD's counterpart by DTensor --------------------------

_SHARDED: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharded", default=None)
# a sharded trace's record of a constraint that padded a split (DTensor then
# keeps splits its ranks outnumber, as GSPMD keeps its padded ones)
_PADS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_pads", default=None)


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (of a sharded trace)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _present(spec: P, mesh) -> P:
    """``spec`` with the axes ``mesh`` lacks dropped (JAX's ``constrain``)."""
    have = set(mesh.axis_names)
    return P(*(tuple(a for a in _axes(part) if a in have) or None for part in spec))


def placements(spec: P, mesh) -> list:
    """DTensor's placements of ``spec`` on ``mesh`` (a ``ProcessMesh``): one a
    ``DeviceMesh`` dim (an axis, or each factor of a factored one),
    ``Shard(dim)`` where ``spec`` splits dim over its axis, else
    ``Replicate()``.  A tuple of axes on one dim must be in mesh order, the
    order DTensor nests its shards in (row-major, as JAX splits)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.dim_axes)
    for dim, part in enumerate(spec):
        order = [mesh.axis_names.index(a) for a in _axes(part)]
        if order != sorted(order):
            raise ValueError(f"{spec}: the axes of dim {dim} are not in mesh order "
                             f"{mesh.axis_names}")
        for i in mesh.dims(_axes(part)) if order else ():
            out[i] = Shard(dim)
    return out


def _dim_axes(device_mesh) -> tuple:
    """The axis of each dim of a trace's ``DeviceMesh`` (``launch.mesh``
    names an axis's factors ``axis.k``)."""
    return tuple(n.split(".")[0] for n in device_mesh.mesh_dim_names)


def _group(dims):
    """The process group of the trace mesh's ``DeviceMesh`` dims ``dims``."""
    return _SHARDED.get().dims_group(tuple(dims))


def _split_over(x, dim: int) -> tuple:
    """The ``DeviceMesh`` dims that split dim ``dim`` of the DTensor ``x``."""
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard(dim))


def _grad_placements(spec: P, mesh) -> list:
    """A shard_map input's cotangent: the rank's block where ``spec``
    splits, a partial sum over the axes it leaves whole."""
    from torch.distributed.tensor import Partial

    return [Partial() if p.is_replicate() else p for p in placements(spec, mesh)]


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute(x: torch.Tensor, spec: P, mesh=None):
    """The DTensor of the global tensor ``x`` (fake, in a trace) laid out by
    ``spec``: its local block is this rank's (``local_block``, which raises
    where JAX's ``shard_shape`` does)."""
    from torch.distributed.tensor import DTensor

    mesh = mesh if mesh is not None else _SHARDED.get()
    block = local_block(x.detach(), spec, mesh)
    return DTensor.from_local(block, mesh.device_mesh, placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=_contiguous_stride(x.shape))


def enter(x, spec: P):
    """A shard_map arm's input: in a sharded trace, ``x`` redistributed to
    its in-spec, and this rank's local block of it (whose cotangent is a
    partial sum over the axes ``spec`` leaves whole); otherwise ``x``,
    already this rank's block."""
    if not is_distributed(x):
        return x
    mesh = _SHARDED.get()
    local_shape(x.shape, spec, mesh)
    x = x.redistribute(mesh.device_mesh, placements(spec, mesh))
    if not x.requires_grad:
        return x.to_local()
    return x.to_local(grad_placements=_grad_placements(spec, mesh))


def leave(y: torch.Tensor, spec: P):
    """A shard_map arm's output: in a sharded trace, this rank's block ``y``
    as the DTensor its out-spec lays out; otherwise ``y``."""
    from torch.distributed.tensor import DTensor

    mesh = _SHARDED.get()
    if mesh is None:
        return y
    shape = list(y.shape)
    for dim, part in enumerate(spec):
        for a in _axes(part):
            shape[dim] *= mesh.shape[a]
    return DTensor.from_local(y, mesh.device_mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _redistribute(x, target: list):
    """``x`` (a DTensor) laid out by ``target``, a partial sum over several
    axes reduced in one all-reduce over their flattened group, as XLA
    reduces it (DTensor reduces one axis at a time), and over one axis to a
    split by one reduce-scatter (``_Scattered``)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _SHARDED.get()
    x = _unpadded(x, target)
    done = [p.is_partial() and not t.is_partial() for p, t in zip(x.placements, target)]
    if sum(done) > 1:
        dims = tuple(i for i, d in enumerate(done) if d)
        op = x.placements[done.index(True)].reduce_op
        y = _reduce(x.to_local(), _REDUCE_OPS[op], mesh.dims_group(dims))
        if op == "avg":
            y = y / math.prod(x.device_mesh.size(i) for i in dims)
        x = DTensor.from_local(y, x.device_mesh,
                               [Replicate() if d else p for p, d in zip(x.placements, done)],
                               run_check=False, shape=x.shape, stride=x.stride())
    scatter = {}
    for i, (p, t) in enumerate(zip(x.placements, target)):
        if p.is_partial() and p.reduce_op == "sum" and t.is_shard():
            scatter.setdefault(t.dim, []).append(i)
    for dim, dims in scatter.items():
        if (not any(q.is_shard(dim) for q in x.placements)
                and x.to_local().shape[dim] % math.prod(x.device_mesh.size(i) for i in dims) == 0):
            x = _Scattered.apply(x, tuple(dims), dim)
    return _moved_together(x, target).redistribute(x.device_mesh, target)


def _moved_together(x, target: list):
    """``x`` with a split that several mesh dims move from one tensor dim to
    another at once (a wave's sequence split over ``pod`` and ``data``
    padded onto its rows) moved by one all-to-all over their flattened
    group, as XLA moves it (DTensor moves one mesh dim at a time, through
    gathers); the block is rank 0's of the new layout (padded where the
    axes outnumber the dim)."""
    from torch.distributed.tensor import DTensor, Shard

    moves = {(p.dim, t.dim) for p, t in zip(x.placements, target)
             if p.is_shard() and t.is_shard() and p.dim != t.dim}
    dims = [i for i, (p, t) in enumerate(zip(x.placements, target))
            if p.is_shard() and t.is_shard() and p.dim != t.dim]
    if len(moves) != 1 or len({_dim_axes(x.device_mesh)[i] for i in dims}) < 2:
        return x
    (a, b), = moves
    if any(p.is_shard(b) or (p.is_shard(a) and i not in dims) for i, p in enumerate(x.placements)):
        return x
    mesh = _SHARDED.get()
    block = x.to_local()
    ways = math.prod(x.device_mesh.size(i) for i in dims)
    _a2a(block.new_empty(ways * math.ceil(block.numel() / ways)), mesh.dims_group(tuple(dims)))
    shape = list(block.shape)
    shape[a] = x.shape[a]
    shape[b] = x.shape[b]
    for i in dims:  # rank 0 holds the first chunk: the ceiling, a mesh dim at a time
        shape[b] = -(-shape[b] // x.device_mesh.size(i))
    return DTensor.from_local(block.new_empty(shape), x.device_mesh,
                              [Shard(b) if i in dims else p for i, p in enumerate(x.placements)],
                              run_check=False, shape=x.shape, stride=x.stride())


class _Scattered(torch.autograd.Function):
    """A partial sum over the mesh dims ``dims`` reduce-scattered along
    ``dim``: one reduce-scatter over their group in every torch version
    (some reduce the whole and slice it, or go a dim at a time).  Its
    transpose gathers the cotangent over the dims (each rank's partial
    takes the whole)."""

    @staticmethod
    def forward(ctx, x, dims, dim):
        from torch.distributed.tensor import DTensor, Shard

        ctx.placements = x.placements
        ways = math.prod(x.device_mesh.size(i) for i in dims)
        block = _scatter0(x.to_local().movedim(dim, 0), ways, _group(dims)).movedim(0, dim)
        out = [Shard(dim) if k in dims else q for k, q in enumerate(x.placements)]
        return DTensor.from_local(block, x.device_mesh, out, run_check=False, shape=x.shape,
                                  stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        return _laid(g, [Replicate() if p.is_partial() else q
                         for p, q in zip(ctx.placements, g.placements)]), None, None


def like(g, p):
    """``g`` laid out as ``p`` in a sharded trace (a gradient takes its
    parameter's layout: a partial sum is reduced, as GSPMD reduces a
    gradient to its donated parameter's sharding); otherwise ``g``."""
    if not (is_distributed(g) and is_distributed(p)):
        return g
    return _redistribute(g, list(p.placements))


def reduced(y):
    """A product's partial sum reduced where it is made, as GSPMD reduces a
    row-parallel product before its consumer (DTensor would carry it on as
    partial); anything else as it is."""
    from torch.distributed.tensor import Replicate

    if not (is_distributed(y) and any(p.is_partial() for p in y.placements)):
        return y
    return _Reduce.apply(y, [Replicate() if p.is_partial() else p for p in y.placements])


class _Reduce(torch.autograd.Function):
    """A partial sum reduced; its transpose hands the cotangent on as it
    lies (each rank's partial takes the whole cotangent), as XLA's
    transpose of an all-reduce does, where DTensor would first lay it out
    as the forward's output."""

    @staticmethod
    def forward(ctx, y, target):
        return _redistribute(y, target)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _fsdp_use(w):
    """A weight at its use: a dim split by the data-parallel axes (``pod``,
    ``data``) alone is gathered over them (FSDP's use-gather, as GSPMD
    gathers such a weight before its product); a dim they split together
    with ``model`` is a tensor-parallel split and stays (the serve layout's
    resident weights)."""
    from torch.distributed.tensor import Replicate

    axes = _dim_axes(w.device_mesh)
    tp_dims = {p.dim for a, p in zip(axes, w.placements) if a == "model" and p.is_shard()}
    target = [Replicate() if a in ("pod", "data") and p.is_shard() and p.dim not in tp_dims
              else p for a, p in zip(axes, w.placements)]
    return _laid(w, target)


def _for_product(x, w):
    """The activation ``x`` of ``x @ w``: a leading dim of ``x`` split over an
    axis that also splits ``w`` is gathered over it, as GSPMD gathers it
    before a tensor-parallel product (the axis serves the weight)."""
    from torch.distributed.tensor import Replicate

    target = [Replicate() if p.is_shard() and p.dim != x.dim() - 1 and q.is_shard() else p
              for p, q in zip(x.placements, w.placements)]
    return _laid(x, target)


# a matmul's einsum by its operands' ranks (batched and broadcast forms)
_MATMUL = {(2, 2): "ij,jk->ik", (3, 2): "bij,jk->bik", (2, 3): "ij,bjk->bik",
           (3, 3): "bij,bjk->bik"}


def _matmul(a, b):
    """``a @ b`` (``torch.matmul``, ``torch.bmm``) on DTensors, as GSPMD
    partitions it: a product with a 2-D weight (both DTensors) by ``_Dot``,
    its backward included; any other of two or three dims by
    ``_blocks_dot``, a plain operand read as replicated."""
    if not (is_distributed(a) or is_distributed(b)) or (a.dim(), b.dim()) not in _MATMUL:
        return NotImplemented
    if is_distributed(a) and is_distributed(b) and b.dim() == 2 and a.dim() > 1:
        return _Dot.apply(reduced(a), b, not torch.is_grad_enabled())
    return _dot_of(_MATMUL[a.dim(), b.dim()], a, b)


class _Dot(torch.autograd.Function):
    """``x @ w`` (``x`` of 2 or 3 dims, ``w`` a 2-D weight) as GSPMD partitions it.
    Forward: the weight gathered at its use (``_weight``), the activation
    gathered where an axis serves the weight (``_for_product``), each
    rank's product of its blocks, and its partial sum reduced where it is
    made.  Backward, as GSPMD partitions the transposed dots by their
    operands' layouts (``_blocks_dot``, the smaller operand gathered where
    an axis splits the two along different labels): the input's cotangent
    keeps the rows' split of the output's (the weight gathered again, as
    JAX's backward gathers it, once with its rematerialized forward's),
    reduced where partial; the weight's cotangent sums over the rows and
    is reduced to the weight's layout."""

    @staticmethod
    def forward(ctx, x, w, once):
        ctx.save_for_backward(x, w)
        rows = "bs"[:x.dim() - 1]
        wu = _weight(w, once)
        return reduced(_blocks_dot(f"{rows}k,kn->{rows}n", _for_product(x, wu), wu,
                                   forward=True, weight=True))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rows = "bs"[:x.dim() - 1]
        g = reduced(g)
        small = w.numel() <= g.numel()  # the operand _blocks_dot gathers
        gx = reduced(_blocks_dot(f"{rows}n,kn->{rows}k", g, _weight(w) if small else w))
        gw = _redistribute(_blocks_dot(f"{rows}k,{rows}n->kn", x, g, list(w.placements)),
                           list(w.placements))
        return gx, gw, None


def _weight(w, once: bool = False):
    """The weight ``w`` at its use (``_fsdp_use``), gathered once where XLA's
    CSE leaves one gather: in a program without gradients (``once``) one a
    weight a trace (a prefill's unrolled waves), and in a backward pass one
    a weight for its rematerialized forward and its transposed dots
    together (the forward's own gather stays apart, as a checkpoint keeps
    it)."""
    task = torch._C._current_graph_task_id()
    if not once and task == -1:
        return _fsdp_use(w)
    return _once(("use", None if once else task, tuple(w.placements)), w.to_local(),
                 lambda: _fsdp_use(w), fresh=False)


def _blocks_dot(equation: str, a, b, keep=None, forward: bool = False,
                weight: bool = False):
    """``torch.einsum(equation, a, b)`` on DTensors (no repeated label, no
    ellipsis), as GSPMD partitions a dot: on each axis, where the operands
    are split along different labels, the smaller one gathered; the label
    left split, split alike in the operand that holds it whole (a slice,
    free); then each rank's einsum of its blocks, the output split along
    the label where it keeps it, a partial sum where the label is summed.
    A label its axis does not divide is gathered, unless an operand holds
    it split so already (padded, as ``constrain`` pads it): it stays.  A
    summed label that one operand would meet only by a split on a mesh dim
    outer to one it holds already (``_reordered``: the blocks lie on other
    ranks, a reshard, not a slice) is gathered in both operands instead.

    In a ``forward`` product, on a mesh dim where one operand splits a
    summed label and the weight (``b`` with ``weight``, else the smaller
    operand) is whole, GSPMD gathers the other and splits the output along
    the weight's own label instead (a slice of it): a channel split carried
    through a dense or a per-channel linear map, with no partial sum to
    reduce.  Its transpose keeps the partial sum.

    ``keep`` (a transposed dot's: the placements of the forward operand
    whose cotangent it makes) is the output's layout where sharding
    propagation gives GSPMD one: on an axis where ``keep`` splits an output
    label, that label is split, in each operand that holds it, and an
    operand without it is gathered over the axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    (la, lb), lo = equation.split("->")[0].split(","), equation.split("->")[1]
    a_small = a.numel() * a.element_size() <= b.numel() * b.element_size()
    # the weight's own output labels (``b``'s, or the smaller operand's)
    b_weight = weight or not a_small
    free = ([c for c in lb if c in lo and c not in la] if b_weight
            else [c for c in la if c in lo and c not in lb])
    mesh, sizes = a.device_mesh, dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    keep = keep if keep is not None else [Replicate()] * mesh.ndim

    def plan(gather):
        pa, pb, po, ways = [], [], [], {}
        for qa, qb, n, want in zip(a.placements, b.placements, mesh.shape, keep):
            ca = la[qa.dim] if qa.is_shard() else None
            cb = lb[qb.dim] if qb.is_shard() else None
            held = (ca, cb)
            summed = ca if ca and ca == cb and ca not in lo else None
            if ca and cb and ca != cb:
                ca, cb = (None, cb) if a_small else (ca, None)
            big = ca if b_weight else cb  # the other operand's split here
            if forward and big and big not in lo and not (ca and cb) and free:
                # the larger operand's summed label gathered, the output split
                # by the smaller's own label: a slice of it, no partial sum
                ca = cb = free[0]
            label = None if (ca or cb) in gather else ca or cb
            kept = lo[want.dim] if want.is_shard() and not summed else None
            if kept and sizes[kept] % (ways.get(kept, 1) * n) == 0:
                label = kept
            if label and sizes[label] % (ways.get(label, 1) * n) and label not in held:
                label = None
            if label:  # a label split over several mesh dims (an axis's factors)
                ways[label] = ways.get(label, 1) * n
            pa.append(Shard(la.index(label)) if label and label in la else Replicate())
            pb.append(Shard(lb.index(label)) if label and label in lb else Replicate())
            po.append(Shard(lo.index(label)) if label and label in lo
                      else Partial() if label else Replicate())
        return pa, pb, po

    pa, pb, po = plan(())
    summed = (set(la) & set(lb)) - set(lo)
    reordered = summed & {*_reordered(a, pa, la), *_reordered(b, pb, lb)}
    if reordered:  # the summed labels would meet by a reshard, not a slice: gathered
        pa, pb, po = plan(reordered)
    y = torch.einsum(equation, _laid_once(a, pa).to_local(), _laid_once(b, pb).to_local())
    shape = tuple(sizes[c] for c in lo)
    return DTensor.from_local(y, mesh, po, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _reordered(x, target: list, labels: str) -> set:
    """The labels of the dims of ``x`` that ``target`` splits on a mesh dim
    outer to one that splits them already: not this rank's slice of its
    block (DTensor nests a dim's splits in mesh order), a reshard."""
    return {labels[t.dim] for i, (p, t) in enumerate(zip(x.placements, target))
            if t.is_shard() and not p.is_shard(t.dim)
            and any(q.is_shard(t.dim) for q in x.placements[i + 1:])}


def _split_last(x) -> tuple:
    """The mesh dims that split the last dim of the DTensor ``x`` (empty for
    a plain tensor)."""
    return _split_over(x, x.dim() - 1) if is_distributed(x) else ()


def _whole_last(x) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate() if p.is_shard(x.dim() - 1) else p for p in x.placements]


def _logsumexp(x, dim, keepdim=False):
    """``torch.logsumexp`` over a split last dim, as GSPMD partitions it: each
    rank's max and sum of exponentials over its block, reduced over the
    axes that split it."""
    from torch.distributed.tensor import DTensor

    dims = _split_last(x)
    if not dims or keepdim or dim not in (-1, x.dim() - 1):
        return NotImplemented
    xl, group = x.to_local(), _group(dims)
    m = _reduce(torch.amax(xl, dim=-1, keepdim=True).detach(), dist.ReduceOp.MAX, group)
    out = (m + torch.log(_Psum.apply(torch.sum(torch.exp(xl - m), dim=-1, keepdim=True),
                                     group)))[..., 0]
    shape = x.shape[:-1]
    return DTensor.from_local(out, x.device_mesh, _whole_last(x), run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


class _Summed(torch.autograd.Function):
    """The ranks' partial sums reduced over ``group``; its transpose hands
    the cotangent to each rank's partial as it is (GSPMD's broadcast,
    free)."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _rows(x, dim, kwargs) -> tuple:
    """The mesh dims that split the last dim of ``x``, where a reduction over
    ``dim`` is one over that dim alone of a DTensor held in no partial sum
    (empty otherwise)."""
    dims = dim if isinstance(dim, (tuple, list)) else (dim,)
    if (set(kwargs) - {"keepdim", "correction"} or len(dims) != 1 or dims[0] is None
            or dims[0] % x.dim() != x.dim() - 1
            or any(p.is_partial() for p in getattr(x, "placements", ()))):
        return ()
    return _split_last(x)


def _row_stat(x, out, keepdim):
    from torch.distributed.tensor import DTensor

    out = out if keepdim else out[..., 0]
    shape = (*x.shape[:-1], 1) if keepdim else x.shape[:-1]
    return DTensor.from_local(out, x.device_mesh, _whole_last(x), run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _mean(x, dim=None, **kwargs):
    """``torch.mean`` over a split last dim, as GSPMD partitions it: each
    rank's sum over its block, reduced over the axes that split it."""
    dims = _rows(x, dim, kwargs)
    if not dims:
        return NotImplemented
    group = _group(dims)
    out = _Summed.apply(torch.sum(x.to_local(), dim=-1, keepdim=True), group) / x.shape[-1]
    return _row_stat(x, out, kwargs.get("keepdim", False))


def _var(x, dim=None, **kwargs):
    """``torch.var`` over a split last dim, as JAX's ``var`` partitions: the
    mean, then each rank's squared deviations summed over its block,
    each sum reduced over the axes that split the dim."""
    dims = _rows(x, dim, kwargs)
    if not dims:
        return NotImplemented
    group, xl, n = _group(dims), x.to_local(), x.shape[-1]
    mu = _Summed.apply(torch.sum(xl, dim=-1, keepdim=True), group) / n
    out = _Summed.apply(torch.sum((xl - mu) ** 2, dim=-1, keepdim=True), group) / (
        n - kwargs.get("correction", 1))
    return _row_stat(x, out, kwargs.get("keepdim", False))


def _gather(x, dim, index, **kwargs):
    """``torch.gather`` of one index a row along a split last dim, as GSPMD
    partitions it: each rank takes the indices its block holds (zeros
    elsewhere) and the takes are summed over the axes that split it."""
    from torch.distributed.tensor import DTensor, Replicate

    dims = _split_last(x)
    if not dims or kwargs or dim not in (-1, x.dim() - 1) or index.shape[-1] != 1:
        return NotImplemented
    mesh, keep = x.device_mesh, _whole_last(x)
    xl = x.to_local()
    if not is_distributed(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim, run_check=False)
    il = index.redistribute(mesh, keep).to_local() - axis_offset(x, x.dim() - 1)
    here = (il >= 0) & (il < xl.shape[-1])
    got = _Psum.apply(torch.where(here, torch.gather(xl, -1, il.clamp(0, xl.shape[-1] - 1)), 0),
                      _group(dims))
    shape = index.shape
    return DTensor.from_local(got, mesh, keep, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _einsum(equation, *operands):
    """A two-operand ``torch.einsum`` on DTensors as GSPMD partitions it
    (``_blocks_dot``): DTensor's own rule would run the einsum's views on
    split dims, gathering them."""
    if len(operands) == 1 and isinstance(operands[0], (tuple, list)):
        operands = tuple(operands[0])
    eq = equation.replace(" ", "")
    if len(operands) != 2 or not any(map(is_distributed, operands)) or "->" not in eq:
        return NotImplemented
    la, lb = eq.split("->")[0].split(",")
    if "." in eq or len(set(la)) < len(la) or len(set(lb)) < len(lb):
        return NotImplemented
    return _dot_of(eq, *operands)


def _dot_of(equation: str, a, b):
    """``_blocks_dot`` of ``a`` and ``b`` (a plain one read as replicated, a
    partial sum reduced), through ``_Einsum`` where each operand's labels
    are in the other or the output (its cotangent is then an einsum); the
    product's partial sum reduced where it is made, as GSPMD reduces a dot
    whose contracted label is split (DTensor would carry it on, to be
    reduced, or reduce-scattered, by a later op)."""
    a, b = _whole([reduced(x) if is_distributed(x) else x for x in (a, b)])
    (la, lb), lo = equation.split("->")[0].split(","), equation.split("->")[1]
    if set(la) <= set(lb + lo) and set(lb) <= set(la + lo):
        return reduced(_Einsum.apply(equation, a, b))
    return reduced(_blocks_dot(equation, a, b))


class _Einsum(torch.autograd.Function):
    """``_blocks_dot`` with GSPMD's backward: each operand's cotangent is the
    transposed einsum of the output's, partitioned by the layouts the
    cotangent and the other operand have (``_blocks_dot``: a cotangent split
    along a label stays split, the other operand sliced or gathered to
    meet it), its partial sum reduced where made.  DTensor's own backward
    would first lay the cotangent out as the output was."""

    @staticmethod
    def forward(ctx, equation, a, b):
        ctx.equation = equation
        ctx.save_for_backward(a, b)
        return _blocks_dot(equation, a, b, forward=True)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        (la, lb), lo = ctx.equation.split("->")[0].split(","), ctx.equation.split("->")[1]
        g = reduced(g)
        ga = (reduced(_blocks_dot(f"{lo},{lb}->{la}", g, b, list(a.placements)))
              if ctx.needs_input_grad[1] else None)
        gb = (reduced(_blocks_dot(f"{lo},{la}->{lb}", g, a, list(b.placements)))
              if ctx.needs_input_grad[2] else None)
        return None, ga, gb


def _add(a, b, **kwargs):
    """``a + b`` of tensors of one shape laid out alike but for partial sums,
    one of them whole where the other is partial: the sum stays partial,
    each rank's blocks added (the whole one counted on the axes' first
    rank, the trace's rank 0), where some torch versions' DTensor reduces
    the partial first and others keep it."""
    if kwargs or not (is_distributed(a) and is_distributed(b)) or a.shape != b.shape:
        return NotImplemented
    out = []
    for p, q in zip(a.placements, b.placements):
        if p != q and not (p.is_partial() and q.is_replicate()
                           or q.is_partial() and p.is_replicate()):
            return NotImplemented
        out.append(p if p.is_partial() else q)
    if not any(p.is_partial() for p in out) or any(
            p.is_partial() and p.reduce_op != "sum" for p in out):
        return NotImplemented
    return _SumOfPartials.apply(a, b, out)


class _SumOfPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, out):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(a.to_local() + b.to_local(), a.device_mesh, out,
                                  run_check=False, shape=a.shape, stride=a.stride())

    @staticmethod
    def backward(ctx, g):
        return g, g, None


# a sharded trace's slices by index: their backward nodes -> the layout of
# the tensor sliced (the slice's transpose, a pad, is laid out as it)
_SLICED: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sliced", default=None)


def _getitem(x, idx):
    """``x[idx]`` of a DTensor by slices: its transpose (``_SliceBack``)
    lays the cotangent out as ``x`` is laid out, as GSPMD gives a pad the
    sharding of the operand whose cotangent it makes."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    if not is_distributed(x) or not all(isinstance(i, slice) or i is Ellipsis for i in parts):
        return NotImplemented
    out = torch.Tensor.__getitem__(x, idx)
    node, sliced = getattr(out, "grad_fn", None), _SLICED.get()
    if node is not None and sliced is not None and node.name().startswith("SliceBackward"):
        sliced[id(node)] = (node, list(x.placements))
    return out


def _host_read(x):
    """``bool`` of a fake tensor: a flag the trace does not carry, read as
    True (a loop that waits on it ends after the round it has run)."""
    from torch._subclasses.fake_tensor import is_fake

    return True if is_fake(x) else NotImplemented


_RULES = {
    torch.matmul: _matmul, torch.Tensor.matmul: _matmul, torch.Tensor.__matmul__: _matmul,
    torch.bmm: _matmul, torch.Tensor.bmm: _matmul,
    torch.logsumexp: _logsumexp, torch.Tensor.logsumexp: _logsumexp,
    torch.gather: _gather, torch.Tensor.gather: _gather,
    torch.einsum: _einsum,
    torch.mean: _mean, torch.Tensor.mean: _mean, torch.var: _var, torch.Tensor.var: _var,
    torch.add: _add, torch.Tensor.add: _add, torch.Tensor.__add__: _add,
    torch.Tensor.__bool__: _host_read,
    torch.Tensor.__getitem__: _getitem,
}


class _Partitioner(TorchFunctionMode):
    """GSPMD's choices where DTensor's own rule would lay out or move
    tensors otherwise, for the calls in ``_RULES``: a matmul (a product with
    a 2-D weight, and its backward), ``logsumexp``, ``gather``, ``mean`` and
    ``var`` along a split last dim, a sum with a partial sum, a
    two-operand ``einsum`` split along different labels, and a host read
    of a flag.  Every other call runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        live = _LIVE.get()
        if live is None:
            return _partitioned(func, args, kwargs)
        return live.call(func, args, kwargs, lambda: _partitioned(func, args, kwargs))


def _partitioned(func, args, kwargs):
    rule = _RULES.get(func)
    if rule is not None:
        out = rule(*args, **kwargs)
        if out is not NotImplemented:
            return out
    return func(*args, **kwargs)


class _Liveness:
    """XLA's dead-code elimination, for the count: a compiled step computes
    nothing that none of its outputs reads (a GNN's last layer's irreps of
    l > 0, which the readout never reads), in the forward or in a
    rematerialized region's recomputation, so it issues none of the
    collectives of such an op.  Each top-level call of the forward
    (``_Partitioner``) is numbered; where every result it returns is a node
    of the autograd graph, its collectives are counted only if the
    backward pass ran one of those nodes, or one of them feeds a result
    outside the graph (a comparison, a ``detach``, an output).  A
    recomputation (``layers.remat``) makes its forward's calls again, and
    each of its calls' collectives is counted as its forward call's (the
    region's call of the same function and rank).  A
    collective that a later call reuses (XLA's CSE, ``_once``) is counted
    where that call is.  A program that runs no backward pass counts every
    collective."""

    def __init__(self):
        self.nodes: list = []      # each forward call's result nodes (empty: counted)
        self.funcs: list = []      # and the function it called
        self.ran: set = set()      # ids of the nodes the backward pass ran
        self.read: list = []       # nodes read outside the graph
        self.reused: list = []     # (a call, a later call that reuses its collective)
        self.at = None             # the forward call whose collectives are issued now
        self.replay = None         # a recomputation's forward calls by function, and its own
        self.starts: list = []     # where each rematerialized region's forward starts

    def region(self):
        """The context for the recomputation of the region whose forward
        starts now (``recomputation``)."""
        self.starts.append(len(self.nodes))
        return self._replaying(self.starts[-1])

    @contextlib.contextmanager
    def _replaying(self, start: int):
        # the region's forward calls: up to the next region's start
        later = [i for i in self.starts if i > start]
        calls: dict = {}
        for i in range(start, min(later, default=len(self.funcs))):
            calls.setdefault(_key(self.funcs[i]), []).append(i)
        before, self.replay = self.replay, (calls, {})
        try:
            yield
        finally:
            self.replay = before

    def call(self, func, args, kwargs, run):
        from torch.utils._pytree import tree_leaves

        outer = self.at
        if torch._C._current_graph_task_id() != -1:  # the backward pass
            if self.replay is None:
                return run()
            self.at = self._replayed(func)
            try:
                return run()
            finally:
                self.at = outer
        i = self.at = len(self.nodes)
        self.nodes.append(())
        self.funcs.append(func)
        try:
            out = run()
        finally:
            self.at = outer
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        nodes = tuple(t.grad_fn for t in outs if t.grad_fn is not None)
        if outs and len(nodes) == len(outs):
            for node in set(nodes):
                node.register_prehook(self._ran(node))
            self.nodes[i] = nodes
        elif outs or getattr(func, "__name__", None) in _HOST_READS:
            # a result outside the graph (a comparison, a detached copy, a
            # value on the host) reads its inputs; a shape reads none
            self.read.extend(t.grad_fn for t in tree_leaves((args, kwargs))
                             if isinstance(t, torch.Tensor) and t.grad_fn is not None)
        return out

    def _replayed(self, func):
        """The forward call a recomputation's call of ``func`` makes again:
        the region's forward call of ``func`` of the same rank among them
        (calls of other functions that one makes and the other does not,
        attribute reads that torch versions differ in, leave it in
        place), or None (counted) past the last."""
        calls, seen = self.replay
        key = _key(func)
        n = seen[key] = seen.get(key, 0) + 1
        mine = calls.get(key, ())
        return mine[n - 1] if n <= len(mine) else None

    def _ran(self, node):
        def hook(grads):
            self.ran.add(id(node))
        return hook

    def dead(self) -> set:
        """The forward calls none of whose results is read: none where no
        backward pass ran."""
        if not self.ran:
            return set()
        live, todo = set(self.ran), list(self.read)
        while todo:
            node = todo.pop()
            if node is None or id(node) in live:
                continue
            live.add(id(node))
            todo.extend(n for n, _ in node.next_functions)
        dead = {i for i, nodes in enumerate(self.nodes)
                if nodes and not any(id(n) in live for n in nodes)}
        return dead - {first for first, later in self.reused if later not in dead}


def _key(func):
    """A called function as a dict key (a bound method-wrapper is one by its
    descriptor)."""
    try:
        hash(func)
    except TypeError:
        return repr(func)
    return func


_HOST_READS = {"item", "tolist", "numpy", "__bool__", "__float__", "__int__", "__index__"}
_LIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_live", default=None)


def recomputation():
    """The context for the recomputation of a rematerialized region whose
    forward starts now (``layers.remat``): in a sharded trace its calls are
    that forward's calls again (``_Liveness``); otherwise none."""
    live = _LIVE.get()
    return contextlib.nullcontext() if live is None else live.region()


def issuing():
    """The dead-code account of the sharded trace (``_Liveness``) and the
    forward call whose collective is being issued (None: counted)."""
    live = _LIVE.get()
    return (None, None) if live is None else (live, live.at)


def axis_offset(x, dim: int) -> int:
    """Where this rank's block of the DTensor ``x`` starts along ``dim``
    (row-major over the mesh dims that split it)."""
    idx = 0
    for i in _split_over(x, dim):
        idx = idx * x.device_mesh.size(i) + x.device_mesh.get_local_rank(i)
    return idx * x.to_local().shape[dim]


def constrain_axis(x, axis: str, dim: int):
    """JAX's constraint of one dim to one axis with the other dims
    unconstrained (``P(UNCONSTRAINED, ..., axis)``): in a sharded trace,
    ``dim`` split over ``axis``, the other axes kept as they lie (a
    partial sum reduced), and the cotangent constrained alike (its
    transpose, ``_Constrain``); otherwise ``x``."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_distributed(x):
        return x
    mesh = _SHARDED.get()
    if x.shape[dim] % mesh.shape[axis]:
        raise ValueError(f"axis {axis!r} ({mesh.shape[axis]}) does not divide dim {dim} of "
                         f"{tuple(x.shape)}")
    target = [Shard(dim) if a == axis else Replicate() if p.is_partial() else p
              for a, p in zip(_dim_axes(x.device_mesh), x.placements)]
    return _Constrain.apply(x, target)


def local(x):
    """This rank's block of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_distributed(x) else x


def psum_over_shards(x: torch.Tensor, like_: torch.Tensor) -> torch.Tensor:
    """A rank's partial reduction ``x`` of its block of ``like_``, summed over
    the axes ``like_`` is split over (none outside a sharded trace)."""
    if not is_distributed(like_):
        return x
    dims = tuple(i for i, p in enumerate(like_.placements) if p.is_shard())
    return _Psum.apply(x, _group(dims)) if dims else x


def materialize(tree):
    """A traced program's outputs as a jit gives them: a partial sum is
    reduced (to replicated); shards stay."""
    from torch.utils._pytree import tree_map

    return tree_map(reduced, tree)


class Replicated:
    """The handler a sharded trace gives DTensor for an op it has no
    sharding rule for: every DTensor input redistributed to replicated
    (the collectives that takes are counted), the op run on the whole
    tensors, its outputs replicated.  An in-place op writes a replicated
    tensor in place, and raises on a sharded one (it cannot change its
    layout in place).  ``ops`` counts the calls by op name."""

    def __init__(self):
        self.ops: dict[str, int] = {}

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_flatten, tree_map

        name = str(op)
        self.ops[name] = self.ops.get(name, 0) + 1
        mesh = next(a.device_mesh for a in tree_flatten((args, kwargs))[0]
                    if isinstance(a, DTensor))
        whole = [Replicate()] * mesh.ndim
        mutable = op._schema.is_mutable
        if mutable and not all(p.is_replicate() for p in args[0].placements):
            raise NotImplementedError(f"{name} writes a sharded tensor in place and has no "
                                      "sharding rule")

        def whole_local(a):
            return a.redistribute(mesh, whole).to_local() if isinstance(a, DTensor) else a

        out = op(*tree_map(whole_local, args), **tree_map(whole_local, kwargs or {}))
        if mutable:
            return args[0]
        return tree_map(lambda o: DTensor.from_local(o, mesh, whole, run_check=False)
                        if isinstance(o, torch.Tensor) else o, out)


def _strided(out) -> bool:
    """Whether a view's result is split as a strided shard (a merge of dims
    whose inner one is split): some torch versions make one, others refuse
    the view; the trace gathers instead, the same in both."""
    from torch.distributed.tensor import placement_types

    strided = getattr(placement_types, "_StridedShard", ())
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return any(isinstance(p, strided) for o in outs if is_distributed(o)
               for p in o.placements)


def _groups(a, b) -> list | None:
    """The dims of two shapes of one size in the runs a view maps onto each
    other: ``[(in dims, out dims)]``, each pair of runs of one product (a
    view splits or merges dims only within a run); None where they do not
    meet."""
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        ii, jj, pa, pb = [i], [j], a[i], b[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb and i < len(a):
                pa, i = pa * a[i], i + 1
                ii.append(i - 1)
            elif pb < pa and j < len(b):
                pb, j = pb * b[j], j + 1
                jj.append(j - 1)
            else:
                return None
        groups.append((ii, jj))
    if (i < len(a) or j < len(b)) and not groups:
        return None
    for k in range(i, len(a)):  # trailing 1s
        groups[-1][0].append(k)
    for k in range(j, len(b)):
        groups[-1][1].append(k)
    return groups


_DP_AXES = ("pod", "data")


def _block_view(x, size, laid_out_only: bool = False):
    """``x.view(size)`` done on this rank's block, or None: each split dim
    kept as one dim of the view (the block viewed alike, version-
    independent where DTensor's rules differ on a padded split), or a dim
    split over the data-parallel axes alone cut into an outer dim they do
    not divide and an inner one they do (a batch of waves' rows and
    sequence: GSPMD splits the rows over the part of the axes that divides
    them and the sequence over the rest, which DTensor cannot place on one
    mesh axis; the trace holds it as the sequence split over all of them,
    a block of the same elements, free, as the view is in GSPMD).  With
    ``laid_out_only``, None unless ``x`` is padded or the view cuts such a
    batch (DTensor's own rule then decides the rest)."""
    from torch.distributed.tensor import DTensor, Shard

    size = list(size)
    if -1 in size:
        size[size.index(-1)] = x.numel() // -math.prod(size)
    groups = _groups(tuple(x.shape), tuple(size))
    if groups is None:
        return None
    where = {d: (ii, jj) for ii, jj in groups for d in ii}
    names = _dim_axes(x.device_mesh)
    out, local = [], list(size)
    for i, p in enumerate(x.placements):
        if not p.is_shard():
            out.append(p)
            continue
        ii, jj = where[p.dim]
        jj = [j for j in jj if size[j] != 1] or jj
        if ii == [p.dim] and len(jj) == 1:
            out.append(Shard(jj[0]))
            local[jj[0]] = x.to_local().shape[p.dim]
            continue
        ways = math.prod(x.device_mesh.size(k) for k, q in enumerate(x.placements)
                         if q == p)
        axes = [names[k] for k, q in enumerate(x.placements) if q == p]  # the factors' axes
        if (ii != [p.dim] or len(jj) != 2 or size[jj[0]] % ways == 0 or size[jj[1]] % ways
                or x.shape[p.dim] % ways or not set(axes) <= set(_DP_AXES)):
            return None
        out.append(Shard(jj[1]))
        local[jj[1]] = size[jj[1]] // ways
        laid_out_only = False
    if laid_out_only and not _padded(x):
        return None
    block = x.to_local()
    if math.prod(local) != block.numel():
        return None
    shape = torch.Size(size)
    return DTensor.from_local(block.reshape(local), x.device_mesh, out, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _tiled_view(x, size):
    """``x.view(size)`` with every split of ``x`` kept, as GSPMD's reshape
    keeps a tiled layout, or None.  In each run of dims the view maps onto
    each other (``_groups``; a dim the view keeps keeps its split, padded
    or not), the splits are one split of the run's
    flattened elements when they tile it: the dims before the innermost
    split one held one element a rank, those after it whole, the mesh
    dims in mesh order.  The view's dims take those mesh dims outermost
    first, each dim as many as its size takes (a dim of ``H * D`` split
    ``k`` ways, viewed as ``(H, D)``: ``gcd(H, k)`` ways on ``H``, the rest
    on ``D``, two factors of one axis), and the split fits where every dim
    but the innermost it reaches is left one element a rank.  A padded
    split the view cuts, or one that does not tile, gives None."""
    from torch.distributed.tensor import DTensor, Shard

    size = list(size)
    if -1 in size:
        size[size.index(-1)] = x.numel() // -math.prod(size)
    groups = _groups(tuple(x.shape), tuple(size))
    if groups is None or any(
            not (p.is_shard() or p.is_replicate() or p.is_partial()) for p in x.placements):
        return None
    mesh, local = x.device_mesh, list(size)
    out, padded = list(x.placements), {x.placements[i].dim for i in _padded(x)}
    for ii, jj in groups:
        split = {d: _split_over(x, d) for d in ii if _split_over(x, d)}
        kept = [j for j in jj if size[j] != 1]
        if len(ii) == 1 and len(kept) == 1 and size[kept[0]] == x.shape[ii[0]]:
            for i in split.get(ii[0], ()):  # a dim the view keeps: its split as it is
                out[i] = Shard(kept[0])
            local[kept[0]] = x.to_local().shape[ii[0]]
            continue
        if not split:
            continue
        if padded & set(ii):
            return None
        inner = max(split)
        order = [i for d in ii for i in split.get(d, ())]
        held = {d: x.shape[d] // math.prod(mesh.size(i) for i in split.get(d, ())) for d in ii}
        if order != sorted(order) or any(held[d] != 1 for d in ii if d < inner):
            return None
        k = 0
        for j in jj:
            ways = 1
            while k < len(order) and size[j] % (ways * mesh.size(order[k])) == 0:
                ways *= mesh.size(order[k])
                out[order[k]] = Shard(j)
                k += 1
            local[j] = size[j] // ways
            if ways < size[j] and k < len(order):
                return None
        if k < len(order):
            return None
    shape = torch.Size(size)
    return DTensor.from_local(x.to_local().reshape(local), mesh, out, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


_VIEWS_BY_SIZE = ("aten.view.default", "aten._unsafe_view.default")


class _Views:
    """The handler a sharded trace gives DTensor for views (and selecting,
    squeezing, unbinding): DTensor's own, and where it refuses one (a dim
    split unevenly by its axes: heads fewer than the ``model`` ranks, a
    batch of waves; a split dim selected or squeezed away) or would give a
    strided shard (a merge of dims whose inner one is split, which some
    torch versions refuse), GSPMD's reshard: a batch of waves' rows cut
    from a dim split over the data-parallel axes laid out as GSPMD lays
    them, and a view that keeps a padded split taken on the blocks
    (``_block_view``, free; both before DTensor's rule, alike in every
    torch version);
    else the axes that split the tensor gathered over one at a time, the
    innermost dim's first (a padded split rematerialized, ``_remat``),
    until it takes the view.  The backward's views take the same path."""

    def __init__(self, table):
        self.table = table

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate

        x, rest = args[0], args[1:]
        by_size = str(op) in _VIEWS_BY_SIZE
        if by_size:  # before DTensor's rule, which differs between torch versions here
            out = _tiled_view(x, rest[0])
            if out is None:
                out = _block_view(x, rest[0], laid_out_only=True)
            if out is not None:
                return out
        held = self.table.pop(op)
        try:
            while True:
                try:
                    out = op(x, *rest, **(kwargs or {}))
                    if not _strided(out):
                        return out
                    why = "a strided shard"
                except (RuntimeError, ValueError) as e:
                    why, error = str(e), e
                block = x.to_local()
                if "Cannot view" in why and not block.is_contiguous():
                    # a strided local block: copy it, move nothing
                    x = DTensor.from_local(block.contiguous(), x.device_mesh, x.placements,
                                           run_check=False, shape=x.shape,
                                           stride=_contiguous_stride(x.shape))
                    continue
                out = _block_view(x, rest[0]) if by_size else None
                if out is not None:
                    return out
                split = [i for i, p in enumerate(x.placements) if p.is_shard()]
                if not split:
                    raise error
                inner = max(split, key=lambda i: (x.placements[i].dim, i))
                if inner in _padded(x):
                    x = _remat(x, [inner])
                    continue
                target, axes = list(x.placements), _dim_axes(x.device_mesh)
                for i in split:  # the axis's factors alike: the axis at once
                    if axes[i] == axes[inner] and x.placements[i] == x.placements[inner]:
                        target[i] = Replicate()
                x = x.redistribute(x.device_mesh, target)
        finally:
            self.table[op] = held


def _whole(tensors) -> list:
    """``tensors`` with each plain one the code made as the replicated
    DTensor it stands for beside the DTensors among them."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next(t.device_mesh for t in tensors if is_distributed(t))
    return [t if is_distributed(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in tensors]


class _Takes:
    """The handler a sharded trace gives DTensor for ``index_select`` along
    dim 0, as GSPMD partitions a gather by its indices: the tensor's dim 0
    whole (gathered where it was split), each rank takes its indices' rows,
    the rows split as the indices and the other dims as the tensor (where
    an axis would split both, the indices are gathered over it).  Along
    another dim that is whole, each rank takes from its own block (the
    indices gathered); along a split one, DTensor's own rule, or
    ``fallback`` where it has none.  The same in every torch version, whose
    own rules for these ops differ."""

    def __init__(self, table, fallback):
        self.table, self.fallback = table, fallback

    def own(self, op, args, kwargs):
        held = self.table.pop(op)
        try:
            return op(*args, **(kwargs or {}))
        except NotImplementedError:
            return self.fallback(op, args, kwargs)
        finally:
            self.table[op] = held

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        x, dim, idx = args
        x, idx = _whole((x, idx))
        dim %= x.dim()
        if dim != 0:
            if any(p.is_shard(dim) or p.is_partial() for p in x.placements):
                return self.own(op, args, kwargs)
            # along a whole dim: each rank takes from its own block
            idx = _laid(idx, [Replicate()] * x.device_mesh.ndim)
            rows = torch.index_select(x.to_local(), dim, idx.to_local())
            shape = (*x.shape[:dim], idx.shape[0], *x.shape[dim + 1:])
            return DTensor.from_local(rows, x.device_mesh, x.placements, run_check=False,
                                      shape=shape, stride=_contiguous_stride(shape))
        xt = [Replicate() if p.is_shard(0) else p for p in x.placements]
        it = [Shard(0) if pi == Shard(0) and not px.is_shard() else Replicate()
              for pi, px in zip(idx.placements, xt)]
        x, idx = _laid(x, xt), _laid(idx, it)
        rows = torch.index_select(x.to_local(), 0, idx.to_local())
        shape = (idx.shape[0], *x.shape[1:])
        return DTensor.from_local(rows, x.device_mesh, [
            pi if pi.is_shard() else px for px, pi in zip(xt, it)],
            run_check=False, shape=shape, stride=_contiguous_stride(shape))


class _Adds(_Takes):
    """The handler for ``index_add`` (and ``index_add_``, whose result it
    returns) along dim 0, as GSPMD partitions a scatter by its indices: on
    each axis that splits the indices or the source rows (or holds the
    source as a partial sum) both take the split and each rank adds its
    rows into the tensor (counted once), and these partial sums are
    reduced; on the other axes the tensor and the source share one layout.
    Along another dim that both hold whole, each rank adds its own block's
    rows (the indices gathered, the two laid out alike); along a split one,
    DTensor's own rule."""

    def along(self, op, args, kwargs, x, dim, idx, src):
        from torch.distributed.tensor import DTensor, Replicate

        x, src = reduced(x), reduced(src)
        target = _alike((x, src), dim)
        inplace = op is torch.ops.aten.index_add_.default
        if any(p.is_shard(dim) for p in (*x.placements, *src.placements)) or (
                inplace and target != list(x.placements)):
            return self.own(op, args, kwargs)
        xl, sl = _laid(x, target).to_local(), _laid(src, target).to_local()
        il = _laid(idx, [Replicate()] * x.device_mesh.ndim).to_local()
        alpha = (kwargs or {}).get("alpha", 1)
        if inplace:
            xl.index_add_(dim, il, sl, alpha=alpha)
            return args[0]
        return DTensor.from_local(torch.index_add(xl, dim, il, sl, alpha=alpha), x.device_mesh,
                                  target, run_check=False, shape=x.shape,
                                  stride=_contiguous_stride(x.shape))

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        x, dim, idx, src = args[:4]
        x, idx, src = _whole((x, idx, src))
        dim %= x.dim()
        if dim != 0:
            return self.along(op, args, kwargs, x, dim, idx, src)
        xt, it, st, out = [], [], [], []
        for px, pi, ps in zip(x.placements, idx.placements, src.placements):
            row = pi == Shard(0) or ps == Shard(0)
            if row or ps.is_partial():
                it.append(Shard(0) if row else Replicate())
                st.append(Shard(0) if row else ps)
                xt.append(px if px.is_partial() else Replicate())
                out.append(Partial())
            else:
                d = ps if ps.is_shard() else (
                    px if px.is_shard() and not px.is_shard(0) else Replicate())
                it.append(Replicate())
                xt.append(d)
                st.append(d)
                out.append(d)
        x, idx, src = _laid(x, xt), _laid(idx, it), _laid(src, st)
        mesh = x.device_mesh
        # x counted once in a partial sum it is whole in: on the axes' first rank
        first = all(mesh.get_local_rank(i) == 0 for i, (o, p) in enumerate(zip(out, xt))
                    if o.is_partial() and not p.is_partial())
        base = x.to_local() if first else torch.zeros_like(x.to_local())
        local = torch.index_add(base, 0, idx.to_local(), src.to_local(),
                                alpha=(kwargs or {}).get("alpha", 1))
        return reduced(DTensor.from_local(local, mesh, out, run_check=False, shape=x.shape,
                                          stride=_contiguous_stride(x.shape)))


def _alike(tensors, dim=None) -> list:
    """One layout for DTensors of one rank: on each axis the split they share
    (one whole there is sliced to it, free), whole where their splits differ
    or fall on ``dim``."""
    from torch.distributed.tensor import Replicate

    target = []
    for ps in zip(*(t.placements for t in tensors)):
        split = {p for p in ps if p.is_shard()}
        p = split.pop() if len(split) == 1 else None
        target.append(p if p is not None and p.dim != dim else Replicate())
    return target


class _Join:
    """The handler a sharded trace gives DTensor for ``stack`` and ``cat``:
    the tensors laid out alike (``_alike``), each rank's blocks joined, a
    new dim whole.  A ``cat`` along a dim they share a split of (each
    tensor's part of it divided evenly) keeps the split, as GSPMD
    partitions a concatenate: each tensor moved off the split by one
    all-to-all over its mesh dims, joined, and the result moved back by
    one more; along any other dim, that dim whole.  DTensor's own rules
    differ between torch versions (some shift a split dim past a new last
    dim of ``stack``, or lay out a ``cat`` along a split dim otherwise)."""

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Shard

        tensors = [reduced(t) for t in _whole(list(args[0]))]
        new = op is torch.ops.aten.stack.default
        dim = (args[1] if len(args) > 1 else (kwargs or {}).get("dim", 0)) % (
            tensors[0].dim() + new)
        target, mesh = _alike(tensors), tensors[0].device_mesh
        dims = () if new else tuple(i for i, p in enumerate(target) if p.is_shard(dim))
        if dims and any(t.shape[dim] % math.prod(mesh.size(i) for i in dims) for t in tensors):
            dims = ()
        if not dims:
            target = _alike(tensors, None if new else dim)
        blocks = [_laid(t, target).to_local() for t in tensors]
        for block in blocks if dims else ():
            _a2a(block, _group(dims))
        y = op(blocks, dim)
        if dims:
            _a2a(y, _group(dims))
        shape = list(tensors[0].shape)
        if new:
            shape.insert(dim, len(tensors))
        else:
            shape[dim] = sum(t.shape[dim] for t in tensors)
        out = [Shard(p.dim + (new and p.dim >= dim)) if p.is_shard() else p for p in target]
        return DTensor.from_local(y, tensors[0].device_mesh, out, run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous_stride(shape))


class _Cross(_Takes):
    """The handler for ``linalg_cross`` of two tensors of one shape: laid
    out alike (``_alike``) with the product's dim whole, each rank's cross
    products of its rows.  Some torch versions' DTensor has no rule for it
    (it would run replicated)."""

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor

        a, b = (reduced(t) for t in _whole(list(args[:2])))
        dim = (kwargs or {}).get("dim", -1) % a.dim()
        if a.shape != b.shape:
            return self.own(op, args, kwargs)
        target = _alike((a, b), dim)
        out = op(_laid(a, target).to_local(), _laid(b, target).to_local(), dim=dim)
        return DTensor.from_local(out, a.device_mesh, target, run_check=False, shape=a.shape,
                                  stride=_contiguous_stride(a.shape))


class _Softmax(_Takes):
    """The handler for ``_softmax`` along a split dim (a decode's logits over
    a cache split by length), as GSPMD partitions it: the flash-decoding
    combine, each rank's max and sum of exponentials over its block reduced
    over the axes that split the dim.  Along a whole dim, DTensor's own."""

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor

        x, dim = args[0], args[1] % args[0].dim()
        dims = _split_over(x, dim)
        if not dims:
            return self.own(op, args, kwargs)
        xl, group = x.to_local(), _group(dims)
        m = _reduce(torch.amax(xl, dim=dim, keepdim=True), dist.ReduceOp.MAX, group)
        e = torch.exp(xl - m)
        out = e / _Psum.apply(torch.sum(e, dim=dim, keepdim=True), group)
        return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())


def _receive(piece: torch.Tensor, dims: tuple) -> torch.Tensor:
    """XLA's collective-permute over the mesh dims ``dims``: ``piece``'s
    shape received from another rank of their group (one op of the SPMD
    program, counted once whichever ranks it moves between)."""
    group = _group(dims)
    buf = torch.empty_like(piece)
    dist.recv(buf, src=dist.get_global_rank(group, 1), group=group)
    return buf


def _permutes(ways: int, out_block: int, in_block: int, lo: int, hi: int, off: int) -> dict:
    """The collective-permutes that move a dim split ``ways`` ways into a
    layout of it split as many ways: each rank's block of the new layout
    (``out_block`` elements from ``rank * out_block``), where it lies in
    ``[lo, hi)``, reads position ``t + off`` of the old layout (blocks of
    ``in_block``).  ``{shift: elements}``: one permute for each distance
    between a rank and the rank it reads from, carrying the most that any
    rank reads over that distance (XLA's halo exchange)."""
    moves = {}
    for r in range(ways):
        t, end = max(lo, r * out_block), min(hi, (r + 1) * out_block)
        while t < end:
            q = (t + off) // in_block
            stop = min(end, (q + 1) * in_block - off)
            if q != r:
                moves[q - r] = max(moves.get(q - r, 0), stop - t)
            t = stop
    return moves


def _shifted(x, block, dim: int, moves: dict, placements, shape):
    """``block``'s shape along the moved layout, the collective-permutes of
    ``moves`` issued over the mesh dims that split ``dim``; the DTensor of
    the result (rank 0's block, the ceiling where its ranks outnumber the
    dim: GSPMD's padding, which DTensor then keeps)."""
    from torch.distributed.tensor import DTensor

    dims = _split_over(x, dim)
    for shift in sorted(moves):
        piece = list(block.shape)
        piece[dim] = moves[shift]
        _receive(block.new_empty(piece), dims)
    ways = math.prod(x.device_mesh.size(i) for i in dims)
    if shape[dim] % ways:
        _PADS.get()["seen"] = True
    local = list(block.shape)
    local[dim] = -(-shape[dim] // ways)
    return DTensor.from_local(block.new_empty(local), x.device_mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _bounds(n: int, start, end) -> tuple:
    start = 0 if start is None else start + n if start < 0 else start
    end = n if end is None else end + n if end < 0 else end
    return min(max(start, 0), n), min(max(end, 0), n)


class _Slice(_Takes):
    """The handler for ``x[..., a:b, ...]`` along a dim split over mesh dims,
    as GSPMD partitions a slice: the result split as the dim was (padded
    where its ranks outnumber it), each rank's block read from the blocks
    that hold it by collective-permutes (``_permutes``: one position of a
    sequence-split hidden state is one permute to the first rank, a half
    of a split head dim one permute to the neighbour).  A strided slice,
    or one of a whole dim, DTensor's own rule."""

    def __call__(self, op, args, kwargs):
        x, dim, start, end, step = (*args, *(0, None, None, 1)[len(args) - 1:])[:5]
        dim %= x.dim()
        n = x.shape[dim]
        start, end = _bounds(n, start, end)
        dims = _split_over(x, dim)
        if (kwargs or step != 1 or end <= start or not dims
                or any(p.is_partial() for p in x.placements)):
            return self.own(op, args, kwargs)
        ways = math.prod(x.device_mesh.size(i) for i in dims)
        m = end - start
        shape = list(x.shape)
        shape[dim] = m
        moves = _permutes(ways, -(-m // ways), -(-n // ways), 0, m, start)
        return _shifted(x, x.to_local(), dim, moves, x.placements, shape)


class _SliceBack(_Takes):
    """The handler for a slice's transpose (``slice_backward``: the
    cotangent written into zeros of the input's shape) along a split dim,
    as GSPMD partitions the pad: split as the cotangent is, each rank's
    block read from the cotangent's blocks by collective-permutes.  Along
    a whole dim, DTensor's own rule."""

    def __call__(self, op, args, kwargs):
        g, sizes, dim, start, end, step = args
        dim %= len(sizes)
        n = sizes[dim]
        start, end = _bounds(n, start, end)
        dims = _split_over(g, dim)
        if (kwargs or step != 1 or end <= start or not dims
                or any(p.is_partial() for p in g.placements)):
            return self.own(op, args, kwargs)
        ways = math.prod(g.device_mesh.size(i) for i in dims)
        moves = _permutes(ways, -(-n // ways), -(-(end - start) // ways), start, end, -start)
        out = _shifted(g, g.to_local(), dim, moves, g.placements, list(sizes))
        node, sliced = torch._C._current_autograd_node(), _SLICED.get() or {}
        if node is not None and id(node) in sliced:  # laid out as the tensor sliced
            out = _laid(out, sliced[id(node)][1])
        return out


class _RowWise(_Takes):
    """The handlers for a row-wise access by several index tensors (``x[rows,
    cols]``, the first index a batch's rows in order, as a decode cache's
    slot writes are) where the tensor is split along an indexed dim, as
    GSPMD partitions such a gather or scatter: the indices (and the
    values) laid out as the tensor's leading dim where it is split there
    and whole along the rest, and each rank serves the indices its block
    holds.  A read (``index``) takes zeros elsewhere, summed over the other
    axes that split an indexed dim; a write (``index_put_``) writes the
    updates that land in its block and keeps the rest.  A single index, or
    no split indexed dim, takes DTensor's own rule."""

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        x, indices = args[0], list(args[1])
        split = [p for p in x.placements if p.is_shard() and p.dim < len(indices)]
        if len(indices) < 2 or any(i is None for i in indices) or not split:
            return self.own(op, args, kwargs)
        mesh = x.device_mesh
        rows = [p if p == Shard(0) else Replicate() for p in x.placements]
        xl = x.to_local()
        rest = _whole((x, *indices, *args[2:3]))[1:]
        il = [_laid(t, rows).to_local() for t in rest[:len(indices)]]
        here = None
        for d in {p.dim for p in split}:
            off, n = axis_offset(x, d), xl.shape[d]
            inside = (il[d] >= off) & (il[d] < off + n)
            here = inside if here is None else here & inside
            il[d] = torch.clamp(il[d] - off, 0, n - 1)
        got = xl[tuple(il)]
        mask = here.reshape(*here.shape, *(1,) * (got.dim() - here.dim()))
        if op is torch.ops.aten.index.Tensor:
            dims = tuple(i for i, p in enumerate(x.placements) if p in split and p != Shard(0))
            got = torch.where(mask, got, 0)
            if dims:
                got = _Psum.apply(got, _group(dims))
            shape = (*torch.broadcast_shapes(*(i.shape for i in indices)),
                     *x.shape[len(indices):])
            return DTensor.from_local(got, mesh, rows, run_check=False, shape=shape,
                                      stride=_contiguous_stride(shape))
        values = _laid(rest[-1], rows).to_local()
        xl.index_put_(tuple(il), torch.where(mask, values, got), *args[3:])
        return x


def _laid_once(x, target: list):
    """``_laid``, the move issued once a backward pass for a value and its
    target (``_once``): XLA's CSE merges a rematerialized forward's reshard
    of an operand with its transposed dots' reshard of the same value (a
    checkpoint keeps the forward's own apart)."""
    task = torch._C._current_graph_task_id()
    if task == -1 or list(x.placements) == target:
        return _laid(x, target)
    return _once(("laid", task, tuple(target)), x.to_local(), lambda: _laid(x, target),
                 fresh=False)


def _laid(x, target: list):
    """The DTensor ``x`` redistributed to ``target`` where it lies otherwise."""
    if list(x.placements) == target:
        return x
    return _unpadded(x, target).redistribute(x.device_mesh, target)


def _padded(x) -> list:
    """The mesh dims of the DTensor ``x`` that split a dim unevenly (GSPMD's
    padding: a rank holds the ceiling of its share)."""
    ways = {}
    for i, p in enumerate(x.placements):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * x.device_mesh.size(i)
    return [i for i, p in enumerate(x.placements)
            if p.is_shard() and x.shape[p.dim] % ways[p.dim]]


def _remat(x, dims: list):
    """XLA's rematerialization of a padded layout: each rank's block written
    into zeros of the whole and all-reduced over the mesh dims ``dims`` (and
    the others that split the same tensor dims), which then hold the
    tensor dims whole."""
    from torch.distributed.tensor import DTensor, Replicate

    tdims = {x.placements[i].dim for i in dims}
    dims = [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim in tdims]
    shape = [n if d in tdims else m for d, (n, m) in enumerate(zip(x.shape, x.to_local().shape))]
    whole = _reduce(x.to_local().new_zeros(shape), dist.ReduceOp.SUM, _group(dims))
    return DTensor.from_local(whole, x.device_mesh,
                              [Replicate() if i in dims else p for i, p in enumerate(x.placements)],
                              run_check=False, shape=x.shape, stride=x.stride())


def _unpadded(x, target: list):
    """``x`` with each padded split that ``target`` does not keep
    rematerialized (``_remat``), where DTensor would gather the padded
    blocks (the padding moved too)."""
    drop = [i for i in _padded(x) if target[i] != x.placements[i]]
    return _remat(x, drop) if drop else x


def _uniform(placements, pm) -> list | None:
    """``placements`` on ``pm``'s factored ``DeviceMesh`` as the unfactored
    mesh's (one an axis), or None where an axis's factors differ."""
    out = []
    for a in pm.axis_names:
        held = {placements[i] for i in pm.dims(a)}
        if len(held) != 1:
            return None
        out.append(held.pop())
    return out


def _redistributor(original):
    """DTensor's ``redistribute_local_tensor`` for a trace over a factored
    mesh: a layout whose axes' factors all hold one placement moves as the
    unfactored mesh moves it (each axis at once, as DTensor moves the
    axis: the records of a mesh nothing is tiled on are unchanged; a
    partial sum over several axes reduced by one all-reduce over their
    flattened group, as XLA reduces it and as some torch versions merge
    DTensor's reductions, a dim at a time in others), any other by
    ``_tiled_move``.  Elsewhere, ``original``."""

    def redistribute_local_tensor(local, current, target, *args, **kwargs):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor._dtensor_spec import DTensorSpec

        pm = _SHARDED.get()
        if pm is None or pm.logical is None or current.mesh != pm.device_mesh:
            return original(local, current, target, *args, **kwargs)
        now, then = _uniform(current.placements, pm), _uniform(target.placements, pm)
        if now is not None and then is not None:
            done = [i for i, (p, t) in enumerate(zip(now, then))
                    if p.is_partial() and t.is_replicate()]
            if len(done) > 1:
                op = now[done[0]].reduce_op
                names = tuple(pm.axis_names[i] for i in done)
                local = _reduce(local, _REDUCE_OPS[op], pm.group(names))
                if op == "avg":
                    local = local / pm.axis_size(names)
                now = [Replicate() if i in done else p for i, p in enumerate(now)]
            return original(local, DTensorSpec(pm.logical, tuple(now), current.tensor_meta),
                            DTensorSpec(pm.logical, tuple(then), target.tensor_meta),
                            *args, **kwargs)
        return _tiled_move(local, current, target)

    return redistribute_local_tensor


def _respec(tree, mesh, placements_of):
    """``tree`` (specs, schemas, tuples) with each ``DTensorSpec`` on
    ``mesh``, its placements mapped by ``placements_of``."""
    import dataclasses

    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSchema

    if isinstance(tree, DTensorSpec):
        return DTensorSpec(mesh, tuple(placements_of(tree.placements)), tree.tensor_meta)
    if isinstance(tree, OpSchema):
        return dataclasses.replace(tree, args_schema=_respec(tree.args_schema, mesh, placements_of),
                                   kwargs_schema=_respec(tree.kwargs_schema, mesh, placements_of))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_respec(t, mesh, placements_of) for t in tree)
    if isinstance(tree, dict):
        return {k: _respec(v, mesh, placements_of) for k, v in tree.items()}
    return tree


def _specs(tree) -> list:
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree, is_leaf=lambda t: isinstance(t, DTensorSpec))
            if isinstance(t, DTensorSpec)]


def _runs(pm, specs) -> tuple:
    """The factored ``DeviceMesh``'s dims cut into runs: the axes where
    every spec of ``specs`` places each axis's factors alike (the
    unfactored mesh), else the consecutive dims that every spec places
    alike (across axes too: fewer dims for DTensor's search)."""
    alike = all(_uniform(t.placements, pm) is not None for t in specs)
    runs = []
    for i, a in enumerate(pm.dim_axes):
        if runs and (pm.dim_axes[runs[-1][-1]] == a or not alike) and all(
                t.placements[i] == t.placements[runs[-1][-1]] for t in specs):
            runs[-1].append(i)
        else:
            runs.append([i])
    return tuple(map(tuple, runs))


def _propagator(original):
    """DTensor's sharding propagation for a trace over a factored mesh: an
    op propagates on the mesh of the runs its operands place alike
    (``_runs``): as on the unfactored mesh where each axis's factors hold
    one placement (the same choices as there), with a dim a run otherwise;
    the result placed back on the factors.  DTensor searches every
    combination of its placements over a mesh's dims: one a factor would
    multiply its work.  Elsewhere, ``original``."""
    import dataclasses

    def propagate_op_sharding(op_schema):
        pm = _SHARDED.get()
        specs = _specs((op_schema.args_schema, op_schema.kwargs_schema))
        if (pm is None or pm.logical is None or not specs
                or any(t.mesh != pm.device_mesh for t in specs)):
            return original(op_schema)
        runs = _runs(pm, specs)

        def expand(placements):
            out = [None] * len(pm.dim_axes)
            for run, p in zip(runs, placements):
                for i in run:
                    out[i] = p
            return out

        out = original(_respec(op_schema, pm.runs_mesh(runs),
                               lambda ps: [ps[run[0]] for run in runs]))
        return dataclasses.replace(
            out, output_spec=_respec(out.output_spec, pm.device_mesh, expand),
            redistribute_schema=_respec(out.redistribute_schema, pm.device_mesh, expand))

    propagate_op_sharding.cache_clear = getattr(original, "cache_clear", lambda: None)
    return propagate_op_sharding


def _tiled_move(block, current, target):
    """GSPMD's reshard of a tiled layout (an axis's factors placed apart) on
    this rank's ``block``, each move one collective over the mesh dims that
    make it: partial sums reduced by one all-reduce, or to a split by one
    reduce-scatter a dim; a split moved to another dim by one all-to-all
    (splits moved between several pairs of dims at once, which XLA cannot
    reshard efficiently: the blocks replicated over their mesh dims by one
    all-gather, then sliced, XLA's full rematerialization); a split
    dropped by one all-gather, after a collective-permute where
    the mesh dims kept on the dim are inner to the ones dropped (the kept
    blocks are not the ranks' own: XLA permutes the ranks first); a split
    added, a slice.  Returns the block of ``target`` (rank 0's)."""
    shape, mesh = current.tensor_meta.shape, current.mesh
    now, then = list(current.placements), list(target.placements)
    if any(not (p.is_shard() or p.is_replicate() or p.is_partial()) or type(p).__name__.startswith(
            "_Strided") for p in (*now, *then)):
        raise NotImplementedError(f"no tiled move from {now} to {then}")
    block = block.contiguous()
    reduce = [i for i, (p, t) in enumerate(zip(now, then)) if p.is_partial() and t.is_replicate()]
    if reduce:
        block = _reduce(block, _REDUCE_OPS[now[reduce[0]].reduce_op], _group(reduce))
    for i in reduce:
        now[i] = then[i]
    scatter = {}
    for i, (p, t) in enumerate(zip(now, then)):
        if p.is_partial() and t.is_shard():
            scatter.setdefault(t.dim, []).append(i)
    for dim, dims in scatter.items():
        ways = math.prod(mesh.size(i) for i in dims)
        if block.shape[dim] % ways:
            block = _reduce(block, dist.ReduceOp.SUM, _group(dims))
        else:
            block = _scatter0(block.movedim(dim, 0), ways, _group(dims)).movedim(0, dim)
        for i in dims:
            now[i] = then[i]
    moves = {}
    for i, (p, t) in enumerate(zip(now, then)):
        if p.is_shard() and t.is_shard() and p.dim != t.dim:
            moves.setdefault((p.dim, t.dim), []).append(i)
    if len(moves) > 1:  # XLA's involuntary full rematerialization: replicate, then slice
        dims = sorted(i for d in moves.values() for i in d)
        ways = math.prod(mesh.size(i) for i in dims)
        block = _gather0(block.reshape(1, -1), ways, _group(dims))
        moves = {}
        for i in dims:
            now[i] = then[i]
    for (a, b), dims in moves.items():
        _a2a(block, _group(dims))
        ways = math.prod(mesh.size(i) for i in dims)
        local = list(block.shape)
        local[a], local[b] = local[a] * ways, -(-local[b] // ways)
        block = block.new_empty(local)
        for i in dims:
            now[i] = then[i]
    for dim in range(len(shape)):
        drop = [i for i, (p, t) in enumerate(zip(now, then))
                if p.is_shard(dim) and not t.is_shard(dim)]
        if not drop:
            continue
        if any(now[i].is_shard(dim) and i > drop[0] for i in range(len(now)) if i not in drop):
            _receive(block, tuple(i for i, p in enumerate(now) if p.is_shard(dim)))
        block = _gather0(block.movedim(dim, 0), math.prod(mesh.size(i) for i in drop),
                         _group(drop)).movedim(0, dim)
        for i in drop:
            now[i] = then[i]
    local = list(shape)
    for dim in range(len(shape)):
        ways = math.prod(mesh.size(i) for i, t in enumerate(then) if t.is_shard(dim))
        local[dim] = -(-shape[dim] // ways)
    return block.new_empty(local)


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as the one all-to-all a card mesh
    makes (on a CPU mesh DTensor makes it an all-gather, as gloo has no
    all-to-all; the accounting mesh stands for cards)."""
    group = mesh.get_group(mesh_dim)
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 group.group_name)


def _dtensor_hooks(name: str) -> list:
    """DTensor's modules that hold the function ``name`` (imported by name
    into several), with the function."""
    import sys

    return [(m, getattr(m, name)) for key, m in list(sys.modules.items())
            if key.startswith("torch.distributed.tensor") and m is not None
            and callable(getattr(m, name, None))]


def _keeps_padding(check, pads: dict):
    """DTensor's shardability check, with a split its ranks outnumber
    allowed once a constraint of the trace has padded one: GSPMD pads such
    a split, where DTensor would move the tensor off it (a pointwise op of
    a padded block and a replicated one resharded)."""

    def shardable(shape, spec, *args, **kwargs):
        if pads and all(p.dim < len(shape) for p in spec.placements if p.is_shard()):
            return True
        return check(shape, spec, *args, **kwargs)

    return shardable


def _forget_layouts() -> None:
    """Clear DTensor's caches of sharding decisions: an entry names the
    process groups of the mesh it was made on, and a later trace's fake
    group of the same layout has groups of other names."""
    from torch.distributed.tensor import DTensor, debug

    clear = getattr(debug, "_clear_sharding_prop_cache", None)
    if clear is not None:
        clear()
    else:
        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()


@contextlib.contextmanager
def sharded_trace(mesh, handler: Replicated | None = None, ops=()):
    """Run the ``with`` block as this rank's program on ``mesh`` (a
    ``ProcessMesh``, normally rank 0 over a fake group): the mesh active
    for the arms, DTensors propagating, plain tensors read as replicated,
    and each op of ``ops`` run through ``handler``."""
    from torch.distributed.tensor import DTensor, placement_types
    from torch.distributed.tensor.experimental import implicit_replication

    table = DTensor._op_dispatcher._custom_op_handlers
    views = _Views(table)
    aten = torch.ops.aten
    view_ops = (aten.view.default, aten._unsafe_view.default, aten.unbind.int,
                aten.select.int, aten.squeeze.dim, aten.squeeze.dims)
    ops = [*ops, *view_ops]
    handlers = {op: views for op in view_ops}
    fallback = handler if handler is not None else Replicated()
    handlers[aten.index_select.default] = _Takes(table, fallback)
    handlers[aten.index_add.default] = handlers[aten.index_add_.default] = _Adds(
        table, fallback)
    handlers[aten._softmax.default] = _Softmax(table, fallback)
    handlers[aten.stack.default] = handlers[aten.cat.default] = _Join()
    handlers[aten.linalg_cross.default] = _Cross(table, fallback)
    handlers[aten.index.Tensor] = handlers[aten.index_put_.default] = _RowWise(table, fallback)
    handlers[aten.slice.Tensor] = _Slice(table, fallback)
    handlers[aten.slice_backward.default] = _SliceBack(table, fallback)
    ops.extend(k for k in handlers if k not in view_ops)
    saved_ops = {op: table.get(op) for op in ops}
    saved_move = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    pads = {}
    checks = _dtensor_hooks("is_tensor_shardable")
    for module, check in checks:
        module.is_tensor_shardable = _keeps_padding(check, pads)
    moves = _dtensor_hooks("redistribute_local_tensor")
    for module, move in moves:
        module.redistribute_local_tensor = _redistributor(move)
    propagator = DTensor._op_dispatcher.sharding_propagator
    propagates = {name: getattr(propagator, name) for name in (
        "propagate_op_sharding", "propagate_op_sharding_non_cached")}  # (fake tensors: the latter)
    for name, propagate in propagates.items():
        setattr(propagator, name, _propagator(propagate))
    for op in ops:
        table[op] = handlers.get(op, handler)
    _forget_layouts()
    token, issued, padded = _SHARDED.set(mesh), _ISSUED.set({}), _PADS.set(pads)
    sliced, live = _SLICED.set({}), _LIVE.set(_Liveness())
    try:
        with set_mesh(mesh), implicit_replication(), _Partitioner():
            yield mesh
    finally:
        for module, check in checks:
            module.is_tensor_shardable = check
        for module, move in moves:
            module.redistribute_local_tensor = move
        for name, propagate in propagates.items():
            setattr(propagator, name, propagate)
        _LIVE.reset(live)
        _SLICED.reset(sliced)
        _PADS.reset(padded)
        _ISSUED.reset(issued)
        _SHARDED.reset(token)
        _forget_layouts()
        placement_types.shard_dim_alltoall = saved_move
        for op, h in saved_ops.items():
            if h is None:
                table.pop(op, None)
            else:
                table[op] = h

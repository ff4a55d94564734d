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
the products with a weight (FSDP's gather at use and in the backward, the
row-parallel sums reduced where made, the backward's transposed dots laid
out by their operands), two-operand ``einsum`` on each rank's blocks, and
``logsumexp``/``gather`` over a split vocabulary; DTensor op handlers take
views, gathers and scatters by indices, the softmax over a length-split
cache (the flash-decoding combine) and the cache's slot reads and writes.
An op DTensor has no rule for runs on its inputs replicated
(``Replicated``), and the trace names it.

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
    axes do not divide is left whole, as the arms' ``token_spec`` leaves a
    small batch, where GSPMD would pad it).  Otherwise the identity:
    outside the explicit arms every rank computes on its own block."""
    if not is_distributed(x):
        return x
    mesh = _SHARDED.get()
    spec = _present(spec, mesh)
    spec = P(*(part if x.shape[d] % math.prod(mesh.shape[a] for a in _axes(part)) == 0
               else None for d, part in enumerate(spec)))
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


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The tiled gather along axis 0; its transpose is a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, ways, group):
        ctx.ways, ctx.group = ways, group
        return _gather0(x, ways, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g, ctx.ways, ctx.group), None, None


def all_to_all(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, 0, 0)``: axis 0 of ``x`` in as many
    equal chunks as ``axes`` has ranks, chunk ``k`` to rank ``k``; the
    chunks received, in source order."""
    return _AllToAll.apply(x, _mesh(mesh).group(axes))


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.psum``: the sum over the ranks of ``axes``, on each."""
    return _Psum.apply(x, _mesh(mesh).group(axes))


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.pmax``: the largest over the ranks of ``axes``, on each."""
    return _reduce(x, dist.ReduceOp.MAX, _mesh(mesh).group(axes))


def pmean(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.pmean``: ``psum`` over the ranks' count."""
    mesh = _mesh(mesh)
    return psum(x, axes, mesh) / mesh.axis_size(axes)


def all_gather(x: torch.Tensor, axes, axis: int = 0, mesh=None) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=axis, tiled=True)``: the ranks'
    ``x`` concatenated along ``axis`` in their order along ``axes``."""
    mesh = _mesh(mesh)
    out = _AllGather.apply(x.movedim(axis, 0), mesh.axis_size(axes), mesh.group(axes))
    return out.movedim(0, axis).contiguous()


# -- the sharded trace: GSPMD's counterpart by DTensor --------------------------

_SHARDED: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharded", default=None)


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
    mesh axis, ``Shard(dim)`` where ``spec`` splits dim over it, else
    ``Replicate()``.  A tuple of axes on one dim must be in mesh order, the
    order DTensor nests its shards in (row-major, as JAX splits)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for dim, part in enumerate(spec):
        order = [mesh.axis_names.index(a) for a in _axes(part)]
        if order != sorted(order):
            raise ValueError(f"{spec}: the axes of dim {dim} are not in mesh order "
                             f"{mesh.axis_names}")
        for i in order:
            out[i] = Shard(dim)
    return out


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
    reduces it (DTensor reduces one axis at a time)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _SHARDED.get()
    done = [p.is_partial() and not t.is_partial() for p, t in zip(x.placements, target)]
    if sum(done) > 1:
        names = tuple(a for a, d in zip(mesh.axis_names, done) if d)
        op = x.placements[done.index(True)].reduce_op
        y = _reduce(x.to_local(), _REDUCE_OPS[op], mesh.group(names))
        if op == "avg":
            y = y / mesh.axis_size(names)
        x = DTensor.from_local(y, x.device_mesh,
                               [Replicate() if d else p for p, d in zip(x.placements, done)],
                               run_check=False, shape=x.shape, stride=x.stride())
    return x.redistribute(x.device_mesh, target)


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

    mesh = _SHARDED.get()
    tp_dims = {p.dim for a, p in zip(mesh.axis_names, w.placements)
               if a == "model" and p.is_shard()}
    target = [Replicate() if a in ("pod", "data") and p.is_shard() and p.dim not in tp_dims
              else p for a, p in zip(mesh.axis_names, w.placements)]
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
        return _Dot.apply(reduced(a), b)
    return _dot_of(_MATMUL[a.dim(), b.dim()], a, b)


class _Dot(torch.autograd.Function):
    """``x @ w`` (``x`` of 2 or 3 dims, ``w`` a 2-D weight) as GSPMD partitions it.
    Forward: the weight gathered at its use (``_fsdp_use``), the activation
    gathered where an axis serves the weight (``_for_product``), each
    rank's product of its blocks, and its partial sum reduced where it is
    made.  Backward, as GSPMD partitions the transposed dots by their
    operands' layouts (``_blocks_dot``, the smaller operand gathered where
    an axis splits the two along different labels): the input's cotangent
    keeps the rows' split of the output's (the weight gathered again, as
    JAX's backward gathers it), reduced where partial; the weight's
    cotangent sums over the rows and is reduced to the weight's layout."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        rows = "bs"[:x.dim() - 1]
        wu = _fsdp_use(w)
        return reduced(_blocks_dot(f"{rows}k,kn->{rows}n", _for_product(x, wu), wu))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rows = "bs"[:x.dim() - 1]
        g = reduced(g)
        gx = reduced(_blocks_dot(f"{rows}n,kn->{rows}k", g, w))
        gw = _redistribute(_blocks_dot(f"{rows}k,{rows}n->kn", x, g), list(w.placements))
        return gx, gw


def _blocks_dot(equation: str, a, b):
    """``torch.einsum(equation, a, b)`` on DTensors (no repeated label, no
    ellipsis), as GSPMD partitions a dot: on each axis, where the operands
    are split along different labels, the smaller one gathered; the label
    left split, split alike in the operand that holds it whole (a slice,
    free); then each rank's einsum of its blocks, the output split along
    the label where it keeps it, a partial sum where the label is summed.
    A label its axis does not divide is gathered (GSPMD would pad it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    (la, lb), lo = equation.split("->")[0].split(","), equation.split("->")[1]
    a_small = a.numel() * a.element_size() <= b.numel() * b.element_size()
    mesh, sizes = a.device_mesh, dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    pa, pb, po = [], [], []
    for qa, qb, n in zip(a.placements, b.placements, mesh.shape):
        ca = la[qa.dim] if qa.is_shard() else None
        cb = lb[qb.dim] if qb.is_shard() else None
        if ca and cb and ca != cb:
            ca, cb = (None, cb) if a_small else (ca, None)
        label = ca or cb
        if label and sizes[label] % n:
            label = None
        pa.append(Shard(la.index(label)) if label and label in la else Replicate())
        pb.append(Shard(lb.index(label)) if label and label in lb else Replicate())
        po.append(Shard(lo.index(label)) if label and label in lo
                  else Partial() if label else Replicate())
    y = torch.einsum(equation, _laid(a, pa).to_local(), _laid(b, pb).to_local())
    shape = tuple(sizes[c] for c in lo)
    return DTensor.from_local(y, mesh, po, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _split_last(x) -> tuple:
    """The axes that split the last dim of the DTensor ``x`` (empty for a
    plain tensor)."""
    if not is_distributed(x):
        return ()
    last = x.dim() - 1
    return tuple(a for a, p in zip(x.device_mesh.mesh_dim_names, x.placements)
                 if p.is_shard(last))


def _whole_last(x) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate() if p.is_shard(x.dim() - 1) else p for p in x.placements]


def _logsumexp(x, dim, keepdim=False):
    """``torch.logsumexp`` over a split last dim, as GSPMD partitions it: each
    rank's max and sum of exponentials over its block, reduced over the
    axes that split it."""
    from torch.distributed.tensor import DTensor

    names = _split_last(x)
    if not names or keepdim or dim not in (-1, x.dim() - 1):
        return NotImplemented
    xl = x.to_local()
    m = pmax(torch.amax(xl, dim=-1, keepdim=True).detach(), names)
    out = (m + torch.log(psum(torch.sum(torch.exp(xl - m), dim=-1, keepdim=True), names)))[..., 0]
    shape = x.shape[:-1]
    return DTensor.from_local(out, x.device_mesh, _whole_last(x), run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _gather(x, dim, index, **kwargs):
    """``torch.gather`` of one index a row along a split last dim, as GSPMD
    partitions it: each rank takes the indices its block holds (zeros
    elsewhere) and the takes are summed over the axes that split it."""
    from torch.distributed.tensor import DTensor, Replicate

    names = _split_last(x)
    if not names or kwargs or dim not in (-1, x.dim() - 1) or index.shape[-1] != 1:
        return NotImplemented
    mesh, keep = x.device_mesh, _whole_last(x)
    xl = x.to_local()
    if not is_distributed(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim, run_check=False)
    il = index.redistribute(mesh, keep).to_local() - axis_offset(x, x.dim() - 1)
    here = (il >= 0) & (il < xl.shape[-1])
    got = psum(torch.where(here, torch.gather(xl, -1, il.clamp(0, xl.shape[-1] - 1)), 0), names)
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
    are in the other or the output (its cotangent is then an einsum)."""
    a, b = _whole([reduced(x) if is_distributed(x) else x for x in (a, b)])
    (la, lb), lo = equation.split("->")[0].split(","), equation.split("->")[1]
    if set(la) <= set(lb + lo) and set(lb) <= set(la + lo):
        return _Einsum.apply(equation, a, b)
    return _blocks_dot(equation, a, b)


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
        return _blocks_dot(equation, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        (la, lb), lo = ctx.equation.split("->")[0].split(","), ctx.equation.split("->")[1]
        g = reduced(g)
        ga = reduced(_blocks_dot(f"{lo},{lb}->{la}", g, b)) if ctx.needs_input_grad[1] else None
        gb = reduced(_blocks_dot(f"{lo},{la}->{lb}", g, a)) if ctx.needs_input_grad[2] else None
        return None, ga, gb


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
    torch.Tensor.__bool__: _host_read,
}


class _Partitioner(TorchFunctionMode):
    """GSPMD's choices where DTensor's own rule would lay out or move
    tensors otherwise, for the calls in ``_RULES``: a matmul (a product with
    a 2-D weight, and its backward), ``logsumexp`` and ``gather`` along a split last dim, a
    two-operand ``einsum`` split along different labels, and a host read
    of a flag.  Every other call runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = _RULES.get(func)
        if rule is not None:
            out = rule(*args, **kwargs)
            if out is not NotImplemented:
                return out
        return func(*args, **kwargs)


def axis_offset(x, dim: int) -> int:
    """Where this rank's block of the DTensor ``x`` starts along ``dim``
    (row-major over the axes that split it)."""
    mesh = _SHARDED.get()
    names = tuple(a for a, p in zip(mesh.axis_names, x.placements)
                  if p.is_shard() and p.dim == dim)
    return _position(mesh, names) * x.to_local().shape[dim] if names else 0


def constrain_axis(x, axis: str, dim: int):
    """JAX's constraint of one dim to one axis with the other dims
    unconstrained (``P(UNCONSTRAINED, ..., axis)``): in a sharded trace,
    ``dim`` split over ``axis``, the other axes kept as they lie (a
    partial sum reduced); otherwise ``x``."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_distributed(x):
        return x
    mesh = _SHARDED.get()
    if x.shape[dim] % mesh.shape[axis]:
        raise ValueError(f"axis {axis!r} ({mesh.shape[axis]}) does not divide dim {dim} of "
                         f"{tuple(x.shape)}")
    target = [Shard(dim) if a == axis else Replicate() if p.is_partial() else p
              for a, p in zip(mesh.axis_names, x.placements)]
    return _redistribute(x, target)


def local(x):
    """This rank's block of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_distributed(x) else x


def psum_over_shards(x: torch.Tensor, like_: torch.Tensor) -> torch.Tensor:
    """A rank's partial reduction ``x`` of its block of ``like_``, summed over
    the axes ``like_`` is split over (none outside a sharded trace)."""
    if not is_distributed(like_):
        return x
    mesh = _SHARDED.get()
    names = tuple(a for a, p in zip(mesh.axis_names, like_.placements) if p.is_shard())
    return psum(x, names, mesh) if names else x


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


class _Views:
    """The handler a sharded trace gives DTensor for views (and selecting,
    squeezing, unbinding): DTensor's own, and where it refuses one (a dim
    split unevenly by its axes: heads fewer than the ``model`` ranks, a
    batch of waves; a split dim selected or squeezed away) or would give a
    strided shard (a merge of dims whose inner one is split, which some
    torch versions refuse), the axes that split the tensor gathered over
    one at a time, the innermost dim's first, until it takes the view
    (GSPMD reshards such a tensor).  The backward's views take the same
    path."""

    def __init__(self, table):
        self.table = table

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate

        x, rest = args[0], args[1:]
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
                split = [i for i, p in enumerate(x.placements) if p.is_shard()]
                if not split:
                    raise error
                target = list(x.placements)
                target[max(split, key=lambda i: (x.placements[i].dim, i))] = Replicate()
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
    another dim, DTensor's own rule, or ``fallback`` where it has none.
    The same in every torch version, whose own rules for these ops
    differ."""

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
        if dim != 0:
            return self.own(op, args, kwargs)
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
    Along another dim, as ``_Takes``."""

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        x, dim, idx, src = args[:4]
        x, idx, src = _whole((x, idx, src))
        if dim != 0:
            return self.own(op, args, kwargs)
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


class _Softmax(_Takes):
    """The handler for ``_softmax`` along a split dim (a decode's logits over
    a cache split by length), as GSPMD partitions it: the flash-decoding
    combine, each rank's max and sum of exponentials over its block reduced
    over the axes that split the dim.  Along a whole dim, DTensor's own."""

    def __call__(self, op, args, kwargs):
        from torch.distributed.tensor import DTensor

        x, dim = args[0], args[1] % args[0].dim()
        names = tuple(a for a, p in zip(x.device_mesh.mesh_dim_names, x.placements)
                      if p.is_shard(dim))
        if not names:
            return self.own(op, args, kwargs)
        xl = x.to_local()
        m = pmax(torch.amax(xl, dim=dim, keepdim=True), names)
        e = torch.exp(xl - m)
        out = e / psum(torch.sum(e, dim=dim, keepdim=True), names)
        return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())


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
            names = tuple(a for a, p in zip(mesh.mesh_dim_names, x.placements)
                          if p in split and p != Shard(0))
            got = torch.where(mask, got, 0)
            if names:
                got = psum(got, names)
            shape = (*torch.broadcast_shapes(*(i.shape for i in indices)),
                     *x.shape[len(indices):])
            return DTensor.from_local(got, mesh, rows, run_check=False, shape=shape,
                                      stride=_contiguous_stride(shape))
        values = _laid(rest[-1], rows).to_local()
        xl.index_put_(tuple(il), torch.where(mask, values, got), *args[3:])
        return x


def _laid(x, target: list):
    """The DTensor ``x`` redistributed to ``target`` where it lies otherwise."""
    return x if list(x.placements) == target else x.redistribute(x.device_mesh, target)


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as the one all-to-all a card mesh
    makes (on a CPU mesh DTensor makes it an all-gather, as gloo has no
    all-to-all; the accounting mesh stands for cards)."""
    group = mesh.get_group(mesh_dim)
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 group.group_name)


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
    handlers[aten.index.Tensor] = handlers[aten.index_put_.default] = _RowWise(table, fallback)
    ops.extend(k for k in handlers if k not in view_ops)
    saved_ops = {op: table.get(op) for op in ops}
    saved_move = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    for op in ops:
        table[op] = handlers.get(op, handler)
    _forget_layouts()
    token = _SHARDED.set(mesh)
    try:
        with set_mesh(mesh), implicit_replication(), _Partitioner():
            yield mesh
    finally:
        _SHARDED.reset(token)
        _forget_layouts()
        placement_types.shard_dim_alltoall = saved_move
        for op, h in saved_ops.items():
            if h is None:
                table.pop(op, None)
            else:
                table[op] = h

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
position; bool tensors travel as ``uint8``.  There is no GSPMD here:
``constrain`` stays the identity, and code outside the arms runs on each
rank's own data-parallel block.

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
    """JAX's sharding constraint.  Without GSPMD, the identity: outside the
    explicit arms every rank computes on its own block."""
    return x


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


def all_to_all(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, 0, 0)``: axis 0 of ``x`` in as many
    equal chunks as ``axes`` has ranks, chunk ``k`` to rank ``k``; the
    chunks received, in source order."""
    mesh = _mesh(mesh)
    src = _wire(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axes))
    return _unwire(out, x.dtype)


def _all_reduce(x: torch.Tensor, axes, op, mesh) -> torch.Tensor:
    mesh = _mesh(mesh)
    y = _wire(x).clone()  # all_reduce works in place
    dist.all_reduce(y, op=op, group=mesh.group(axes))
    return _unwire(y, x.dtype)


def psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.psum``: the sum over the ranks of ``axes``, on each."""
    return _all_reduce(x, axes, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.pmax``: the largest over the ranks of ``axes``, on each."""
    return _all_reduce(x, axes, dist.ReduceOp.MAX, mesh)


def pmean(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """``jax.lax.pmean``: ``psum`` over the ranks' count."""
    mesh = _mesh(mesh)
    return psum(x, axes, mesh) / mesh.axis_size(axes)


# all_gather_into_tensor is all_gather_single on newer torch (same arguments)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, axes, axis: int = 0, mesh=None) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=axis, tiled=True)``: the ranks'
    ``x`` concatenated along ``axis`` in their order along ``axes``."""
    mesh = _mesh(mesh)
    src = _wire(x.movedim(axis, 0))
    out = src.new_empty((mesh.axis_size(axes) * src.shape[0], *src.shape[1:]))
    _gather_into(out, src, group=mesh.group(axes))
    return _unwire(out.movedim(0, axis).contiguous(), x.dtype)

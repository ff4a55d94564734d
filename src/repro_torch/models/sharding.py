"""Partition specs, and the per-device shapes they give on a mesh.

The counterpart of ``repro.models.sharding``.  The port runs in one
process on one card, so no mesh is ever active: ``active_axes`` is empty
and ``constrain`` is the identity, as JAX's are without a mesh, and the
model code that calls them runs unchanged.  What stays is the accounting:
``P`` names the mesh axes that split each dim of a tensor (JAX's
``PartitionSpec``, read as a tuple), and ``local_shape`` gives the shape
one device holds, by JAX's rule (``NamedSharding(mesh, spec).shard_shape``):
a dim split ``w`` ways holds ``dim / w``, and a dim that ``w`` does not
divide is an error.

JAX's version shims (``repro.compat``: ``current_mesh``, ``set_mesh``,
``shard_map``, ``pallas_native``, ``compat_make_mesh``) have no
counterpart: they wrap jax APIs that differ across jax versions.
"""

from __future__ import annotations

import math


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


def active_axes() -> tuple:
    """The axes of the active mesh: none, since the port never activates one."""
    return ()


def constrain(x, spec: P):
    """JAX's sharding constraint; with no mesh active, the identity."""
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

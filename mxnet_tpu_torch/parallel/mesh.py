"""Device meshes on torch devices: the part tensor-parallel serving needs.

The port of ``mxnet_tpu/parallel/mesh.py``'s ``make_mesh`` and
``PartitionSpec``.  A :class:`Mesh` is an ordered axis map over a flat
list of ``torch.device``s; a :class:`NamedSharding` pairs it with a
:class:`PartitionSpec` and places a tensor as one shard a mesh device.

The visible devices are the physical ones (every CUDA card, or the CPU)
each repeated ``MXTPU_TORCH_VIRTUAL_DEVICES`` times (default 1): the
port's counterpart of the reference tests' forced host devices, which
lets one H100, or the CPU, hold a ``{'tp': 3}`` mesh whose shards share
the one device.  A mesh whose devices are distinct cards raises
``NotImplementedError``: moving partial sums between cards is ROADMAP
§A item 13's multi-card half, which needs a machine with more than one
card to prove.
"""

from __future__ import annotations

import math

import torch

from ..base import env_int

__all__ = ["make_mesh", "Mesh", "NamedSharding", "PartitionSpec",
           "visible_devices", "ENV_VIRTUAL"]

ENV_VIRTUAL = "MXTPU_TORCH_VIRTUAL_DEVICES"


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, or None for a
    dimension that is not split.  ``PartitionSpec()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def visible_devices(kind="cuda"):
    """The devices a mesh may take: every physical device of ``kind``
    (``"cuda"``: each card; ``"cpu"``: the CPU), each repeated
    ``MXTPU_TORCH_VIRTUAL_DEVICES`` times, card-major."""
    kind = torch.device(kind).type
    if kind == "cuda":
        phys = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        phys = [torch.device(kind)]
    n = max(1, env_int(ENV_VIRTUAL, 1))
    return [d for d in phys for _ in range(n)]


class Mesh:
    """A named grid over ``devices`` (row-major in ``axis_names``).
    ``shape`` is the ordered ``{axis: size}`` map; ``device_ids`` the
    positions of the devices among the visible ones."""

    def __init__(self, devices, axis_names, sizes, device_ids=None):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device_ids = (list(device_ids) if device_ids is not None
                           else list(range(len(self.devices))))

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(axes, devices=None):
    """A :class:`Mesh` from an ordered ``{axis_name: size}`` dict; a size
    of -1 absorbs the remaining devices (like a reshape wildcard)::

        mesh = make_mesh({"tp": 3})

    ``devices`` defaults to :func:`visible_devices` of CUDA when a card
    is present, else of the CPU.  Raises ``ValueError`` when the mesh
    needs more devices than there are, and ``NotImplementedError`` when
    it would span distinct devices."""
    if devices is None:
        devices = visible_devices("cuda" if torch.cuda.is_available()
                                  else "cpu")
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    n_dev = len(devices)
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n_dev % known:
            raise ValueError(
                f"cannot infer axis: {n_dev} devices, known {known}")
        sizes[sizes.index(-1)] = n_dev // known
    total = math.prod(sizes)
    if total > n_dev:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n_dev}")
    devs = [torch.device(d) for d in devices[:total]]
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"mesh {dict(zip(names, sizes))} spans distinct devices "
            f"{sorted({str(d) for d in devs})}: a mesh over more than one "
            "card is ROADMAP §A item 13's multi-card half, not ported; "
            f"set {ENV_VIRTUAL} to hold the mesh on one device")
    return Mesh(devs, names, sizes, device_ids=range(total))


class NamedSharding:
    """A :class:`PartitionSpec` on a mesh: where each shard of a tensor
    lives.  Only a 1-D mesh is placed (the serving ``{'tp': N}`` mesh);
    its axis may split at most one dimension."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def split_dim(self, ndim):
        """The tensor dimension the mesh axis splits (None: replicated).
        Raises ``ValueError`` for a spec the placement cannot honour."""
        if len(self.mesh.axis_names) != 1:
            raise ValueError(f"placement needs a 1-D mesh, got "
                             f"{self.mesh.shape}")
        axis = self.mesh.axis_names[0]
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec!r} has {len(self.spec)} "
                             f"entries for a {ndim}-D tensor")
        dims = []
        for i, e in enumerate(self.spec):
            if e is None:
                continue
            if e != axis:
                raise ValueError(f"spec {self.spec!r} names {e!r}, not the "
                                 f"mesh axis {axis!r}")
            dims.append(i)
        if len(dims) > 1:
            raise ValueError(f"spec {self.spec!r} splits {len(dims)} "
                             f"dimensions on one axis {axis!r}")
        return dims[0] if dims else None

    def place(self, x):
        """``x`` (a CPU tensor) on the mesh: the tensor itself on the
        mesh's device when replicated (every mesh device is that one
        device, so one copy serves them all), else a list of shards, one
        a mesh device, each sliced on the host and copied alone (no full
        copy lands on the device)."""
        dim = self.split_dim(x.dim())
        dev = self.mesh.devices[0]
        if dim is None:
            return x.to(dev)
        n = self.mesh.size
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split {n} ways (spec {self.spec!r})")
        return [c.contiguous().to(d, copy=True)
                for c, d in zip(torch.chunk(x, n, dim), self.mesh.devices)]

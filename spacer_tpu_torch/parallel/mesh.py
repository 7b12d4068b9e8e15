"""Device mesh over torch.distributed ranks (counterpart of
spacer_tpu/parallel/mesh.py).

One process per device, as torchrun runs the reference.  The mesh has
the JAX package's axes (data, fsdp, tp); rank r sits at the row-major
coordinates of r over those sizes, as `np.asarray(devices).reshape(sizes)`
places device r there: tp is the fastest axis, so a tp group is contiguous
ranks, as on one NVLink host.  It holds the process groups the port's
collectives use, each at this rank's coordinates on the other axes: the
fsdp axis (params are sharded over it), the data axis (gradients of a shard
are summed over it), data x fsdp ("batch": the batch axes, at one tp
index), the tp axis (tensor parallelism, parallel/tp.py), fsdp x tp
("model": every piece of one tensor, at one data index), and for experts
placed over data or data x fsdp (parallel/expert.py) the pieces of one
such tensor: data x tp ("data_tp", at one fsdp index; built only where
data and tp are both > 1, else the data or the tp group) and every rank
("all": the world group).

A mesh built with a "pipe" entry in its shape also has JAX's pipeline axis
(parallel/pipeline.py), leading and slowest: rank r then sits at the
row-major coordinates of r over (pipe, data, fsdp, tp), every group above
is one per pipe index, and a "pipe" group joins the stages of one (data,
fsdp, tp) coordinate.  A mesh without it keeps its axes, coordinates and
groups as they were.  The pipe composes with data only: fsdp or tp > 1
beside pipe > 1 raises ValueError (JAX's pipeline tests have no such
mesh).
"""

from __future__ import annotations

import math

AXES = ("data", "fsdp", "tp")
PIPE = "pipe"


# copied from spacer_tpu/parallel/mesh.py mesh_shape_for
def mesh_shape_for(n_devices: int, tp: int = 1, fsdp: int | None = None
                   ) -> dict[str, int]:
    """Pick a (data, fsdp, tp) factorization of n_devices.

    Default: all non-tp devices go to fsdp (ZeRO-3-like: batch sharded over
    data*fsdp, params sharded over fsdp).
    """
    assert n_devices % tp == 0, (n_devices, tp)
    rest = n_devices // tp
    if fsdp is None:
        fsdp = rest
    assert rest % fsdp == 0, (rest, fsdp)
    return {"data": rest // fsdp, "fsdp": fsdp, "tp": tp}


class Mesh:
    """This rank's place on a (data, fsdp, tp) mesh, or a (pipe, data,
    fsdp, tp) one, and its process groups.

    `shape` maps every axis to its size (`mesh.shape["fsdp"]` reads as in
    JAX); `coords` maps every axis to this rank's index on it.  `groups`
    maps "fsdp", "data", "tp", "batch" (data x fsdp), "model" (fsdp x tp),
    "data_tp" (data x tp), "all" and, with a pipe axis, "pipe" to
    torch.distributed process groups; a
    Mesh built without them (tests that only place batches) has none and
    cannot run a collective."""

    def __init__(self, shape: dict, rank: int, groups: dict | None = None):
        self.shape = _full_shape(shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on a mesh of {self.size}")
        self.rank = int(rank)
        rest, coords = self.rank, {}
        for a in reversed(self.shape):
            coords[a] = rest % self.shape[a]
            rest //= self.shape[a]
        self.coords = {a: coords[a] for a in self.shape}
        self.groups = dict(groups or {})
        self.warm = set()    # axes whose P2P communicators are set up

    def group(self, name: str):
        if name not in self.groups:
            raise RuntimeError(f"this Mesh has no {name!r} process group "
                               "(build it with create_mesh)")
        return self.groups[name]

    def peers(self, name: str) -> list:
        """The global ranks of this rank's group `name`, in group order
        (point-to-point calls name their peers by global rank)."""
        return next(g for g in _axis_groups(self.shape)[name]
                    if self.rank in g)

    @property
    def batch_index(self) -> int:
        """This rank's index over the batch axes (data major, fsdp minor)."""
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def _full_shape(shape: dict) -> dict:
    """Every axis -> its size (missing axes 1), "pipe" leading where the
    shape names it; ValueError for a pipe beside fsdp or tp > 1."""
    full = {a: int(shape.get(a, 1)) for a in AXES}
    if PIPE in shape:
        full = {PIPE: int(shape[PIPE]), **full}
        if full[PIPE] > 1 and (full["fsdp"] > 1 or full["tp"] > 1):
            raise ValueError(f"mesh {full}: the pipe axis composes with "
                             "data only (fsdp and tp must be 1)")
    return full


def _axis_groups(shape: dict) -> dict:
    """{group name: rank lists}: one group per coordinate of the axes a
    group does not span (fsdp: per (data, tp); data: per (fsdp, tp); tp:
    per (data, fsdp); batch = data x fsdp: per tp; model = fsdp x tp: per
    data; where data and tp are both > 1, data_tp = data x tp: per fsdp),
    ranks row-major over (data, fsdp, tp); with a pipe axis each of
    these per pipe index, ranks row-major over (pipe, data, fsdp, tp), and
    "pipe" per (data, fsdp, tp)."""
    S = shape.get(PIPE, 1)
    D, F, T = shape["data"], shape["fsdp"], shape["tp"]

    def rank(d, f, t, p=0):
        return ((p * D + d) * F + f) * T + t

    groups = {
        "fsdp": [[rank(d, f, t, p) for f in range(F)]
                 for p in range(S) for d in range(D) for t in range(T)],
        "data": [[rank(d, f, t, p) for d in range(D)]
                 for p in range(S) for f in range(F) for t in range(T)],
        "tp": [[rank(d, f, t, p) for t in range(T)]
               for p in range(S) for d in range(D) for f in range(F)],
        "batch": [[rank(d, f, t, p) for d in range(D) for f in range(F)]
                  for p in range(S) for t in range(T)],
        "model": [[rank(d, f, t, p) for f in range(F) for t in range(T)]
                  for p in range(S) for d in range(D)],
    }
    if D > 1 and T > 1:   # else data x tp is the data or the tp group
        groups["data_tp"] = [[rank(d, f, t, p) for d in range(D)
                              for t in range(T)]
                             for p in range(S) for f in range(F)]
    if PIPE in shape:
        groups[PIPE] = [[rank(d, f, t, p) for p in range(S)]
                        for d in range(D) for f in range(F) for t in range(T)]
    return groups


def create_mesh(shape: dict | None = None, tp: int = 1) -> Mesh:
    """Build this rank's Mesh over the initialized process group.

    `shape` maps axis name -> size; missing axes get size 1 ("pipe" is an
    axis only where named).  Its product must equal the world size.  With
    shape=None, uses mesh_shape_for(world, tp).  Every rank must call it
    (new_group is collective)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialized process group "
                           "(parallel.multihost.initialize)")
    world = dist.get_world_size()
    if shape is None:
        shape = mesh_shape_for(world, tp=tp)
    full = _full_shape(shape)
    if math.prod(full.values()) != world:
        raise ValueError(f"mesh {full} != {world} processes")
    rank = dist.get_rank()
    groups = {}
    # new_group is collective: every rank creates every group, in order
    for name, lists in _axis_groups(full).items():
        for ranks in lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    # the pieces of an expert tensor placed over data (x fsdp) with tp
    # (parallel/fsdp.SPLITS); a pipe axis places no experts
    groups.setdefault("data_tp", groups["tp" if full["data"] == 1 else "data"])
    if PIPE not in full:
        groups["all"] = dist.group.WORLD
    return Mesh(full, rank, groups)

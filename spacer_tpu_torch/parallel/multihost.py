"""Process-group setup and host-side exchanges (counterpart of
spacer_tpu/parallel/multihost.py).

The port runs one process per device under torchrun, as the reference does
(run_SpaceR_SG_RLVR.sh:9-21): `initialize()` joins the process group from
torchrun's environment (NCCL on CUDA; gloo only when the CPU is asked for),
`global_mesh` builds the (data, fsdp, tp) mesh over all ranks, and the
helpers below carry the exchanges the SG-RLVR loop needs: python objects
(encodings, completion rewards) gathered from or broadcast to every rank,
metric means, and row shards of a tensor gathered onto every rank.

Without an initialized process group (a plain single-process run) every
helper is the identity.  Once a group exists, a world of one runs the same
collectives as any other world.

Every collective the port issues goes through this module's counters
(`collective_stats`): per kind, the calls and the bytes of their input
tensors (a shard for an all-gather, the whole padded tensor for a
reduce-scatter, a pickle for an object exchange), and with
`time_collectives(True)` on CUDA their CUDA-event time.  Tensor
parallelism's collectives (parallel/tp.py) count under their own kinds,
"tp_all_reduce", "tp_all_gather" and "tp_max"; ring attention's
(ops/ring_attention.py) under "ring_p2p" and "ring_all_gather", the
pipeline's (parallel/pipeline.py) under "pp_send", "pp_recv",
"pp_broadcast", "pp_all_gather" and "pp_all_reduce".  Point-to-point
transfers go through `p2p`, one dist.batch_isend_irecv per call (NCCL
deadlocks on unpaired blocking sends).
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Any

import numpy as np
import torch

_STATS = defaultdict(lambda: {"calls": 0, "bytes": 0})
_EVENTS: list = []
_TIMING = [False]


def reset_collective_stats():
    _STATS.clear()
    _EVENTS.clear()


def time_collectives(on: bool = True):
    """Record a CUDA event pair around every collective on CUDA tensors
    from now on (read back, summed, by collective_stats)."""
    _TIMING[0] = bool(on)


def collective_stats() -> dict:
    """{kind: {"calls", "bytes"[, "ms"]}} since the last reset; "ms" sums
    the CUDA-event times of the timed calls (it synchronizes the card)."""
    out = {k: dict(v) for k, v in _STATS.items()}
    if _EVENTS:
        torch.cuda.synchronize()
        for kind, a, b in _EVENTS:
            out[kind]["ms"] = out[kind].get("ms", 0.0) + a.elapsed_time(b)
    return out


class _Record:
    """Count one collective (and time it on CUDA when timing is on)."""

    def __init__(self, kind: str, nbytes: int, cuda: bool):
        self.kind, self.nbytes = kind, int(nbytes)
        self.events = None
        if _TIMING[0] and cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        s = _STATS[self.kind]
        s["calls"] += 1
        s["bytes"] += self.nbytes
        if self.events:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events:
            self.events[1].record()
            _EVENTS.append((self.kind, *self.events))
        return False


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(device: str = "cuda", **kwargs) -> None:
    """init_process_group from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT), or from explicit `kwargs`
    (init_method, world_size, rank, ...), after torch.cuda.set_device(
    LOCAL_RANK) on CUDA.

    Idempotent.  With no torchrun environment and no kwargs it is a
    single-process no-op, as JAX's initialize() is without a cluster.  The
    backend is NCCL on CUDA and gloo on the CPU (`device="cpu"`); a failing
    rendezvous or backend raises, never degrading to another backend or to
    one process."""
    dist = _dist()
    if dist.is_initialized():
        return
    if not kwargs and not all(k in os.environ for k in _TORCHRUN_ENV):
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: CUDA is not available; "
                               "pass the CPU explicitly to use gloo")
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        torch.cuda.set_device(local)
        kwargs.setdefault("device_id", torch.device("cuda", local))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend=kwargs.pop("backend", backend), **kwargs)


def global_mesh(tp: int = 1, fsdp: int | None = None):
    """Mesh over all ranks.  tp ranks form the fastest axis; fsdp caps the
    fsdp-axis size of the rest, the remaining ranks go to `data` (e.g. 8
    ranks, tp=2, fsdp=2 -> data=2)."""
    from spacer_tpu_torch.parallel.mesh import create_mesh, mesh_shape_for

    return create_mesh(mesh_shape_for(process_count(), tp=tp, fsdp=fsdp))


# -- tensor collectives (counted) --------------------------------------------


def record(kind: str, x: torch.Tensor):
    """Count a collective of `kind` on x that a group of one need not issue
    (parallel/tp.py at tp 1)."""
    record_bytes(kind, x.numel() * x.element_size())


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group,
                    kind: str = "all_gather"):
    with _Record(kind, x.numel() * x.element_size(), x.is_cuda):
        _dist().all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group,
                   kind: str = "reduce_scatter"):
    """SUM-reduce `x` over the group; this rank keeps its equal part."""
    with _Record(kind, x.numel() * x.element_size(), x.is_cuda):
        _dist().reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_reduce(x: torch.Tensor, group, kind: str = "all_reduce",
               op: str = "sum"):
    """SUM (or MAX) over the group, in place."""
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _Record(kind, x.numel() * x.element_size(), x.is_cuda):
        dist.all_reduce(x, op=red, group=group)
    return x


def broadcast(x: torch.Tensor, src: int, group, kind: str = "broadcast"):
    """Rank `src`'s x (a global rank) on every rank of the group, in place."""
    with _Record(kind, x.numel() * x.element_size(), x.is_cuda):
        _dist().broadcast(x, src, group=group)
    return x


def _nbytes(pairs) -> int:
    return sum(t.numel() * t.element_size() for t, _ in pairs)


def p2p(sends=(), recvs=(), group=None, send_kind: str = "p2p_send",
        recv_kind: str | None = None):
    """Send each (tensor, peer) of `sends` and receive into each (buffer,
    peer) of `recvs` in one dist.batch_isend_irecv, and wait for all of it
    (peers are global ranks).  Counted: `send_kind` one call with the bytes
    sent, `recv_kind` (if given) one call with the bytes received; the
    batch is timed under the first of the two that counts.  Empty lists
    issue and count nothing."""
    sends, recvs = list(sends), list(recvs)
    if not sends and not recvs:
        return
    dist = _dist()
    ops = ([dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs])
    counted = [(k, pairs) for k, pairs in ((send_kind, sends),
                                            (recv_kind, recvs))
               if k is not None and pairs]
    for kind, pairs in counted[1:]:
        record_bytes(kind, _nbytes(pairs))
    kind, pairs = counted[0] if counted else (send_kind, sends)
    with _Record(kind, _nbytes(pairs), ops[0].tensor.is_cuda):
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def warm_p2p(mesh, axis: str):
    """Open the point-to-point communicators of this rank's `axis` group
    of `mesh` once: NCCL makes them lazily, and the first
    batch_isend_irecv on a group must include every rank of it (here each
    rank sends to the next around the group)."""
    if axis in mesh.warm or mesh.shape[axis] == 1:
        return
    ranks, i, n = mesh.peers(axis), mesh.coords[axis], mesh.shape[axis]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if _dist().get_backend() == "nccl" else torch.device("cpu"))
    x, got = torch.zeros(1, device=dev), torch.empty(1, device=dev)
    p2p([(x, ranks[(i + 1) % n])], [(got, ranks[(i - 1) % n])],
        mesh.group(axis), send_kind="p2p_warm_up")
    mesh.warm.add(axis)


def record_bytes(kind: str, nbytes: int):
    """Count one call of `kind` moving `nbytes` without timing it."""
    with _Record(kind, nbytes, False):
        pass


# -- python objects (counted) ------------------------------------------------


def _object_bytes(obj) -> int:
    import pickle

    return len(pickle.dumps(obj))


def all_gather_objects(obj: Any, group=None) -> list[Any]:
    """Gather a python object from every rank (reward strings, encodings:
    the analogue of accelerate's gather_object), in rank order."""
    if not is_initialized():
        return [obj]
    dist = _dist()
    out = [None] * dist.get_world_size(group)
    with _Record("object_gather", _object_bytes(obj), False):
        dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_from_host0(obj: Any) -> Any:
    """Rank 0's object on every rank (broadcast_object_list)."""
    if not is_initialized():
        return obj
    box = [obj if process_index() == 0 else None]
    with _Record("object_broadcast",
                 _object_bytes(obj) if process_index() == 0 else 0, False):
        _dist().broadcast_object_list(box, src=0)
    return box[0]


def barrier():
    """Wait for every rank (no-op without a process group)."""
    if is_initialized():
        _dist().barrier()


def mean_across_hosts(value: float) -> float:
    """Mean of a scalar metric over the ranks (gather_for_metrics)."""
    if not is_initialized():
        return float(value)
    return float(np.mean(all_gather_objects(float(value))))


# -- batches -----------------------------------------------------------------


def fetch_to_host(local: torch.Tensor, mesh, axes=("data", "fsdp")
                  ) -> np.ndarray:
    """Row shards -> the full array, identical on every rank (numpy).

    `local` holds this rank's rows of an array whose dim 0 is split over
    `axes` (("data", "fsdp"), ("data",), or () for a replicated array),
    every shard the same size."""
    if mesh is None or not axes:
        return local.cpu().numpy()
    F = mesh.shape["fsdp"]
    world = mesh.shape["data"] * F    # the batch group (one tp index)
    out = torch.empty((world * local.shape[0], *local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    all_gather_into(out, local, mesh.group("batch"))
    parts = out.reshape(world, *local.shape)
    if tuple(axes) == ("data",):
        parts = parts[::F]     # fsdp replicas hold the same data shard
    return parts.reshape(-1, *local.shape[1:]).cpu().numpy()


def global_batch_from_local(local_batch: dict, mesh,
                            batch_axes=("data", "fsdp")):
    """This rank's numpy rows -> its rows of the global batch, split over
    the mesh's `batch_axes`.

    With one device per process a rank's local rows ARE its shard of the
    global batch whenever the row count tiles the batch axes; a dim that
    does not tile is exchanged and replicated, the fallback JAX applies
    (global_batch_from_local)."""
    from spacer_tpu_torch.parallel.partition import _BATCH_DIM1_KEYS

    if mesh is None or not is_initialized():
        return local_batch
    total = math.prod(mesh.shape[a] for a in batch_axes)
    nproc = process_count()
    out = {}
    for k, x in local_batch.items():
        x = np.asarray(x)
        dim = 1 if k in _BATCH_DIM1_KEYS else 0
        if x.ndim > dim and (x.shape[dim] * nproc) % total == 0:
            out[k] = x
            continue
        parts = all_gather_objects(x)
        out[k] = np.concatenate(parts, axis=dim) if x.ndim > dim else parts[0]
    return out


def replicate_to_mesh(x, mesh) -> torch.Tensor:
    """A host value the same on every rank (the caller's contract, as JAX's:
    assemble it with all_gather_objects first) -> this rank's copy on the
    mesh's device: the CPU under a gloo process group, the current CUDA
    device under NCCL; without a process group CUDA where there is a card,
    else the CPU.  A plain device put: no collective."""
    if is_initialized():
        group = next(iter(mesh.groups.values()), None)
        on_cpu = _dist().get_backend(group) == "gloo"
    else:
        on_cpu = not torch.cuda.is_available()
    device = (torch.device("cpu") if on_cpu
              else torch.device("cuda", torch.cuda.current_device()))
    return torch.as_tensor(np.asarray(x), device=device)


def place_global_batch(batch: dict, mesh):
    """A global batch, identical on every rank -> this rank's rows of it
    (partition.place_batch).  mesh=None returns the batch as it is."""
    if mesh is None:
        return batch
    from spacer_tpu_torch.parallel.partition import place_batch

    return place_batch(batch, mesh)


# -- local launcher ----------------------------------------------------------


def local_store():
    """A TCPStore server on a free port of this host (bound to port 0 and
    kept: the port is never released between its choice and its use), for
    ranks this process starts.  Keep it alive until they have joined."""
    return _dist().TCPStore("127.0.0.1", 0, None, True,
                            wait_for_workers=False)


def shutdown() -> None:
    """Destroy this process's process group, if it has one (idempotent;
    local, no collective)."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def store_env(store, rank: int, world: int) -> dict:
    """torchrun's environment for rank `rank` of `world` whose rendezvous
    is the caller's `store` (local_store): every rank, rank 0 included,
    connects to it as a client, as torchrun's workers connect to their
    agent's store (TORCHELASTIC_USE_AGENT_STORE)."""
    return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world),
                TORCHELASTIC_USE_AGENT_STORE="True")


def _launch_entry(rank, fn, world, env, device, threads, args):
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    initialize(device=device)
    try:
        fn(rank, *args)
        barrier()
    finally:
        _dist().destroy_process_group()


def launch_local(fn, world: int, args=(), device: str = "cuda",
                 timeout: float | None = None, threads: int = 0):
    """Run fn(rank, *args) in `world` fresh processes on this host, joined
    in one process group through torchrun's environment (initialize(): NCCL
    with one card per rank on CUDA, gloo on the CPU), as
    `torchrun --nproc_per_node world` would, their rendezvous a store this
    process holds (local_store).  `fn` must be importable by name.  Raises
    if a rank raises or the run outlasts `timeout` seconds (every rank is
    then killed)."""
    import time

    import torch.multiprocessing as mp

    store = local_store()
    ctx = mp.start_processes(
        _launch_entry, args=(fn, world, store_env(store, 0, world), device,
                             threads, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(None if deadline is None
                           else max(1e-3, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                   f"past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()

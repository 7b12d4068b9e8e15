"""Host-memory offload of optimizer state (counterpart of
spacer_tpu/parallel/offload.py, the ZeRO-3 CPU-offload equivalent).

Between updates the Adam moments (and a gradient-accumulation buffer) live
in page-locked host memory, which frees their bytes on the card for the
rollout's KV caches and the update's activations.  `offload_to_host`
copies a state tree's CUDA tensors into ONE host arena, registered with
the CUDA driver (cudaHostRegister) at its exact size; torch's pinned
allocator would round every allocation up to a power of two.  The
optimizer then streams the state through the card one moment group at a
time (`GroupStream`): the next group's host-to-device copy runs on a side
stream while the card computes on this one, and each result streams back
into its host tensor in place, so the arena is allocated once.

On the CPU "host" and "device" are the same memory: CPU tensors stay where
they are and `GroupStream` hands them over as they are, so the path runs
(and is tested) without a card, as JAX's CPU backend runs its offload.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

# arena offsets are aligned to this many bytes (any dtype view is legal)
_ALIGN = 512


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _tensors(tree):
    out = []
    _map(lambda t: out.append(t), tree)
    return out


def mem_available_bytes() -> int | None:
    """The host's MemAvailable (/proc/meminfo), or None where it is not
    readable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def _unregister(ptr: int):
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _host_arena(nbytes: int) -> torch.Tensor:
    """A uint8 CPU tensor of `nbytes`, page-locked by cudaHostRegister and
    unregistered when its memory is freed (the last view's storage holds
    the numpy buffer, whose finalizer unregisters before the free)."""
    avail = mem_available_bytes()
    try:
        buf = np.empty(max(nbytes, 1), np.uint8)
    except MemoryError as e:
        raise RuntimeError(
            f"offload: cannot allocate {nbytes / 1e9:.2f} GB of host memory "
            f"(MemAvailable {avail / 1e9 if avail else float('nan'):.2f} GB)"
        ) from e
    ptr = buf.ctypes.data
    err = torch.cuda.cudart().cudaHostRegister(ptr, buf.nbytes, 0)
    if int(getattr(err, "value", err)) != 0:
        raise RuntimeError(
            f"offload: cudaHostRegister of {nbytes / 1e9:.2f} GB failed "
            f"({err}); MemAvailable "
            f"{avail / 1e9 if avail else float('nan'):.2f} GB")
    fin = weakref.finalize(buf, _unregister, ptr)
    fin.atexit = False
    return torch.from_numpy(buf)


def _to_arena(t) -> bool:
    """CUDA tensors, and, on a host with a card, CPU tensors not yet
    page-locked (a state restored from a checkpoint)."""
    return t.device.type == "cuda" or (
        t.device.type == "cpu" and torch.cuda.is_available()
        and not t.is_pinned())


def offload_to_host(tree):
    """Every CUDA tensor of a state tree (nested NamedTuples, lists, tuples,
    dicts; other leaves pass through) copied into one page-locked host
    arena, and with it, where a card exists, every CPU tensor that is not
    page-locked yet.  On a host without a card CPU tensors are returned as
    they are."""
    cuda = [t for t in _tensors(tree) if _to_arena(t)]
    if not cuda:
        return tree
    offsets, total = {}, 0
    for t in cuda:
        if id(t) not in offsets:
            offsets[id(t)] = total
            total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    arena = _host_arena(total)
    done = {}

    def move(t):
        if not _to_arena(t):
            return t
        if id(t) not in done:
            off, n = offsets[id(t)], t.numel() * t.element_size()
            h = arena[off:off + n].view(t.dtype).view(t.shape)
            h.copy_(t)
            done[id(t)] = h
        return done[id(t)]

    out = _map(move, tree)
    torch.cuda.synchronize()
    return out


def restore_into(host_tree, tree):
    """`tree` (a state of the same structure, e.g. restored from a
    checkpoint) with its tensors' values copied into `host_tree`'s tensors
    in place: an offloaded state keeps its arena, so a resume needs no
    second one.  Raises ValueError where the structures differ."""
    hosts = _tensors(host_tree)
    if len(hosts) != len(_tensors(tree)):
        raise ValueError("restore_into: the states have different structures")
    it = iter(hosts)

    def put(t):
        h = next(it)
        if h.shape != t.shape or h.dtype != t.dtype:
            raise ValueError(f"restore_into: {tuple(t.shape)} {t.dtype} into "
                             f"{tuple(h.shape)} {h.dtype}")
        return h.copy_(t)

    return _map(put, tree)


def to_device(tree, device):
    """Inverse of offload_to_host: every tensor of the tree on `device`."""
    device = torch.device(device)
    return _map(lambda t: t.to(device), tree)


def is_on_host(tree) -> bool:
    """Whether the tree has tensors and all of them are in host memory."""
    ts = _tensors(tree)
    return bool(ts) and all(t.device.type == "cpu" for t in ts)


def host_bytes(tree) -> int:
    """Bytes of the tree's tensors that are in host memory."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree)
               if t.device.type == "cpu")


class GroupStream:
    """Streams a list of items (each a list of tensors) of optimizer state
    through `device`, one item at a time.

    `get(j)` returns item j on the device and starts item j + 1's copy on
    a side stream, so the next copy overlaps this item's arithmetic;
    `put(j, tensors)` takes item j's results: host-resident items copy them
    back into their own tensors in place (on the side stream, after the
    arithmetic), device-resident items take the new tensors.  `finish()`
    waits for the copies back; `items` then holds the state.  Items already
    on `device` (and every item on the CPU) pass through without a copy."""

    def __init__(self, items, device):
        self.items = [list(x) for x in items]
        self.device = torch.device(device)
        self.host = self.device.type == "cuda" and any(
            t.device.type == "cpu" for x in self.items for t in x)
        self.pending = {}
        if self.host:
            self.side = torch.cuda.Stream(self.device)

    def _prefetch(self, j: int):
        if j >= len(self.items) or j in self.pending:
            return
        main = torch.cuda.current_stream(self.device)
        # allocated on the main stream; the side stream writes them only
        # after the main stream's work queued so far
        dev = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
               for t in self.items[j]]
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            for d, h in zip(dev, self.items[j]):
                d.copy_(h, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.side)
        self.pending[j] = (ev, dev)

    def get(self, j: int):
        if not self.host:
            return self.items[j]
        self._prefetch(j)
        self._prefetch(j + 1)
        ev, dev = self.pending.pop(j)
        torch.cuda.current_stream(self.device).wait_event(ev)
        return dev

    def put(self, j: int, tensors):
        if not self.host:
            self.items[j] = list(tensors)
            return
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            for h, d in zip(self.items[j], tensors):
                h.copy_(d, non_blocking=True)
                d.record_stream(self.side)

    def finish(self):
        if self.host:
            self.side.synchronize()
        return self.items

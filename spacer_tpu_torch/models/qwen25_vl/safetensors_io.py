"""Reader and writer of the safetensors format, in torch and the standard
library only (the card's machine has no `safetensors` package).

A file is an 8-byte little-endian header length N, N bytes of JSON
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}} (offsets relative to the end of the header), then the raw
little-endian tensor bytes.  HF's sharded layout is a directory of such files
plus `model.safetensors.index.json` ({"metadata": {"total_size"},
"weight_map": {name: file}}).

The reader memory-maps each tensor's byte range of a file on demand and
hands it out as a read-only view of that map (`torch.frombuffer`; bf16
bytes are read as int16 and viewed as bf16); `release` unmaps it once its
caller has copied it, so a streaming load holds about one tensor of the
checkpoint in host memory.  (One map per tensor rather than per file: a
user-space kernel such as gVisor counts a whole file mapping as resident
once any of it is touched, and faults pages dropped by madvise back in.)
The writer writes the header first, then each tensor's bytes as its
producer hands them over, so it never holds a second host copy of the set.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from typing import Callable, Iterable, NamedTuple

import torch

INDEX_FILE = "model.safetensors.index.json"

# safetensors dtype name -> (torch dtype the bytes are read as, dtype handed out)
_DTYPES = {
    "F32": (torch.float32, torch.float32),
    "F16": (torch.float16, torch.float16),
    "BF16": (torch.int16, torch.bfloat16),
    "I8": (torch.int8, torch.int8),
    "U8": (torch.uint8, torch.uint8),
    "I32": (torch.int32, torch.int32),
    "I64": (torch.int64, torch.int64),
}
_NAMES = {out: name for name, (_, out) in _DTYPES.items()}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class SafetensorsFile:
    """One .safetensors file: its header read at once, each tensor mapped
    read-only when asked for."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._maps: dict[str, mmap.mmap] = {}
        size = os.fstat(self._file.fileno()).st_size
        head = self._file.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes past the end")
        header = json.loads(self._file.read(n))
        self.metadata = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}, "
                                 f"not one of {sorted(_DTYPES)}")
            begin, end = e["data_offsets"]
            itemsize = _DTYPES[e["dtype"]][0].itemsize
            if (not 0 <= begin <= end <= size - self._base
                    or end - begin != _numel(e["shape"]) * itemsize):
                raise ValueError(f"{path}: {name} offsets {begin}..{end} do "
                                 f"not hold shape {e['shape']} {e['dtype']}")
        self._entries = header

    def keys(self):
        return self._entries.keys()

    def get_tensor(self, name: str) -> torch.Tensor:
        """A read-only view of a map of the tensor's bytes: copy it before
        any in-place use."""
        e = self._entries[name]
        raw, out = _DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        n = _numel(e["shape"])
        if n == 0:
            return torch.empty(e["shape"], dtype=out)
        start = (self._base + begin) // mmap.ALLOCATIONGRANULARITY * \
            mmap.ALLOCATIONGRANULARITY
        if name not in self._maps:
            self._maps[name] = mmap.mmap(
                self._file.fileno(), self._base + end - start,
                access=mmap.ACCESS_READ, offset=start)
        with warnings.catch_warnings():
            # the map is read-only; callers copy (see the docstring)
            warnings.filterwarnings("ignore", "The given buffer is not writable")
            t = torch.frombuffer(self._maps[name], dtype=raw, count=n,
                                 offset=self._base + begin - start)
        return t.view(out).reshape(e["shape"])

    def release(self, name: str) -> None:
        """Unmap `name` once no tensor views it any more (while one does,
        the map goes with the last view)."""
        mm = self._maps.pop(name, None)
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass

    def close(self) -> None:
        for name in list(self._maps):
            self.release(name)
        self._file.close()


class CheckpointShards:
    """Every tensor of a checkpoint directory, by name: the files that
    `model.safetensors.index.json`'s weight_map names, else every
    `*.safetensors` in the directory."""

    def __init__(self, checkpoint_dir: str):
        index = os.path.join(checkpoint_dir, INDEX_FILE)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            weight_map = None
            files = sorted(f for f in os.listdir(checkpoint_dir)
                           if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors in {checkpoint_dir}")
        self.files = {f: SafetensorsFile(os.path.join(checkpoint_dir, f))
                      for f in files}
        self._where = {}
        for fname, sf in self.files.items():
            for k in sf.keys():
                self._where[k] = sf
        if weight_map is not None:
            missing = [k for k, f in weight_map.items()
                       if self._where.get(k) is not self.files[f]]
            if missing:
                raise ValueError(f"{checkpoint_dir}: the index names "
                                 f"{len(missing)} tensors its shards do not "
                                 f"hold, e.g. {missing[:3]}")

    def keys(self):
        return self._where.keys()

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get_tensor(name)

    def release(self, name: str) -> None:
        self._where[name].release(name)

    def close(self) -> None:
        for sf in self.files.values():
            sf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TensorSpec(NamedTuple):
    """A tensor to write: its name, dtype and shape up front (for the
    header), and a producer called once, when its bytes are due."""
    name: str
    dtype: torch.dtype
    shape: tuple
    produce: Callable[[], torch.Tensor]


def nbytes(spec: TensorSpec) -> int:
    return _numel(spec.shape) * spec.dtype.itemsize


def save_file(specs: Iterable[TensorSpec], path: str,
              metadata: dict | None = None) -> int:
    """Write `specs` to one safetensors file in their order; returns the
    bytes of tensor data.  Each producer's tensor (any device) must have the
    spec's dtype and shape; it is copied to the host alone and written."""
    specs = list(specs)
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for s in specs:
        if s.dtype not in _NAMES:
            raise ValueError(f"{s.name}: dtype {s.dtype} cannot be written")
        header[s.name] = {"dtype": _NAMES[s.dtype], "shape": list(s.shape),
                          "data_offsets": [offset, offset + nbytes(s)]}
        offset += nbytes(s)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)      # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for s in specs:
            t = s.produce()
            if t.dtype != s.dtype or tuple(t.shape) != tuple(s.shape):
                raise ValueError(f"{s.name}: produced {t.dtype} "
                                 f"{tuple(t.shape)}, declared {s.dtype} "
                                 f"{tuple(s.shape)}")
            t = t.detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
            del t
    return offset


def save_sharded(specs: Iterable[TensorSpec], checkpoint_dir: str,
                 max_shard_bytes: int, metadata: dict | None = None) -> list:
    """HF's sharded layout: specs grouped in order into files of at most
    `max_shard_bytes` (a larger tensor gets a file of its own), named
    model-0000i-of-0000n.safetensors, plus the index.  Returns the files."""
    shards, size = [[]], 0
    for s in specs:
        if shards[-1] and size + nbytes(s) > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(s)
        size += nbytes(s)
    n = len(shards)
    names = [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)]
    weight_map, total = {}, 0
    for fname, shard in zip(names, shards):
        total += save_file(shard, os.path.join(checkpoint_dir, fname),
                           metadata)
        weight_map.update({s.name: fname for s in shard})
    with open(os.path.join(checkpoint_dir, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return names

"""HF checkpoint directories as lazy state dicts, with no `safetensors`
or `transformers`.

Counterpart of the transformers call in
dynamo_tpu/models/registry.py::_load_llama_checkpoint, which loads the
whole model in f32 first. Here a directory's weights are opened as a
name -> tensor mapping whose tensors are views of the memory-mapped files,
read from disk only as each is used (models/llama.py's
params_from_torch_state_dict uploads them one layer at a time), so an 8B
checkpoint never holds a second copy of its weights on the host.

- `model.safetensors`, or shards named by `model.safetensors.index.json`:
  an 8-byte little-endian header length, a JSON header of
  {name: {dtype, shape, data_offsets}}, then the data. F32, F16 and BF16
  are read (bf16 with `torch.frombuffer`, no f32 copy); any other dtype
  (I8, F8_E4M3, the packed ints of GPTQ/AWQ) is refused by name.
- `pytorch_model.bin`, or shards named by `pytorch_model.bin.index.json`:
  `torch.load(weights_only=True, mmap=True)`.

`save_safetensors` writes the same format (fixtures, and the smoke's
checkpoints on the card).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Iterator

import torch

#: safetensors dtype names the reader takes
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}

SAFETENSORS = "model.safetensors"
BIN = "pytorch_model.bin"


class _SafetensorsFile:
    """One mapped safetensors file: its header, and tensors as views."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            # copy-on-write: writable for torch.frombuffer, never written
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._start = 8 + n
        self.entries = header
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise ValueError(
                    f"{path}: tensor {name!r} is {e['dtype']}; dynamo_tpu_torch reads F32, F16 "
                    "and BF16 checkpoints only (quantized checkpoints are not served)")

    def tensor(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        dtype = _DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        count = (end - begin) // dtype.itemsize
        t = torch.frombuffer(self._map, dtype=dtype, count=count, offset=self._start + begin)
        return t.reshape(e["shape"])


class StateDict(Mapping):
    """A checkpoint's tensors by name, each opened when it is first read:
    a view of the mapped file (safetensors) or of torch.load's mmap (.bin),
    on the CPU in the file's dtype."""

    def __init__(self, sources: dict[str, object]):
        #: tensor name -> the file object or loaded dict holding it
        self._sources = sources

    def __getitem__(self, name: str) -> torch.Tensor:
        src = self._sources[name]
        if isinstance(src, _SafetensorsFile):
            return src.tensor(name)
        return src[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._sources)

    def __len__(self) -> int:
        return len(self._sources)


def _shards(path: str, index_name: str) -> list[str]:
    with open(os.path.join(path, index_name)) as f:
        weight_map = json.load(f)["weight_map"]
    return sorted(set(weight_map.values()))


def load_state_dict(path: str) -> StateDict:
    """The weights of an HF checkpoint directory (or one .safetensors or
    .bin file) as a lazy StateDict. Safetensors are preferred to .bin
    where a directory holds both, as transformers prefers them."""
    if os.path.isfile(path):
        d, files = os.path.dirname(path), [os.path.basename(path)]
        st = path.endswith(".safetensors")
    elif os.path.exists(os.path.join(path, SAFETENSORS)):
        d, files, st = path, [SAFETENSORS], True
    elif os.path.exists(os.path.join(path, SAFETENSORS + ".index.json")):
        d, files, st = path, _shards(path, SAFETENSORS + ".index.json"), True
    elif os.path.exists(os.path.join(path, BIN)):
        d, files, st = path, [BIN], False
    elif os.path.exists(os.path.join(path, BIN + ".index.json")):
        d, files, st = path, _shards(path, BIN + ".index.json"), False
    else:
        raise FileNotFoundError(
            f"{path}: no {SAFETENSORS}, {BIN} or sharded index of either")
    sources: dict[str, object] = {}
    for name in files:
        fp = os.path.join(d, name)
        if st:
            src = _SafetensorsFile(fp)
            names = src.entries
        else:
            src = torch.load(fp, map_location="cpu", weights_only=True, mmap=True)
            for k, t in src.items():
                if t.dtype not in _NAMES:
                    raise ValueError(f"{fp}: tensor {k!r} is {t.dtype}; dynamo_tpu_torch reads "
                                     "float32, float16 and bfloat16 checkpoints only")
            names = src
        for k in names:
            if k in sources:
                raise ValueError(f"{path}: tensor {k!r} is in two shards")
            sources[k] = src
    return StateDict(sources)


def save_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """Write F32/F16/BF16 tensors (any device) as one safetensors file,
    its header padded to 8 bytes as the reference library pads it."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"save_safetensors: {name!r} is {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().contiguous().cpu().reshape(-1)
            f.write(memoryview(host.view(torch.uint8).numpy()))

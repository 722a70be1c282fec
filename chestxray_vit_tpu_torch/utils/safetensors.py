"""The safetensors file format, read and written with torch alone.

The JAX package reads and writes HF weight files through the
``safetensors`` package; the port keeps its own reader and writer of the
same format, so that it imports and exports HF folders without that
package. A file is::

    8 bytes     N, the header's length (unsigned, little-endian)
    N bytes     JSON: {name: {"dtype": "F32", "shape": [...],
                              "data_offsets": [begin, end]}, ...,
                       "__metadata__": {str: str}} (optional)
    the rest    each tensor's bytes (C order, little-endian) at its
                offsets, which count from the end of the header

The header is padded with spaces to a multiple of 8 bytes and the writer
lays the tensors out by descending item size, then name, as the
``safetensors`` package does, so every tensor sits at an offset aligned to
its item size. Tensors are read with ``torch.frombuffer``, so BF16 needs
no numpy.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _header(tensors: Mapping[str, torch.Tensor],
            metadata: Optional[Mapping[str, str]]):
    """(header bytes with the length prefix, tensors in file order)."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"code here (one of {sorted(DTYPES)})")
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    return struct.pack("<Q", len(text)) + text, order


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) to
    ``path``."""
    prefix, order = _header(tensors, metadata)
    with open(path, "wb") as f:
        f.write(prefix)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def _parse(buf: bytearray) -> Dict[str, torch.Tensor]:
    if len(buf) < 8:
        raise ValueError("not a safetensors file: shorter than its header "
                         "length")
    (n,) = struct.unpack("<Q", bytes(buf[:8]))
    if 8 + n > len(buf):
        raise ValueError(f"safetensors header of {n} bytes runs past the "
                         f"end of a {len(buf)}-byte file")
    header = json.loads(bytes(buf[8:8 + n]).decode())
    header.pop("__metadata__", None)
    base, out = 8 + n, {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: safetensors dtype {info['dtype']} is "
                             f"not read here (one of {sorted(DTYPES)})")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize or base + end > len(buf):
            raise ValueError(f"{name}: offsets {begin}..{end} do not hold "
                             f"{shape} {info['dtype']}")
        if not numel:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        start = base + begin
        if start % itemsize:         # another writer's unaligned layout
            chunk, start = bytearray(buf[start:base + end]), 0
        else:
            chunk = buf
        out[name] = torch.frombuffer(chunk, dtype=dtype, count=numel,
                                     offset=start).reshape(shape)
    return out


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file at ``path``, by name, on the CPU (sharing
    one buffer that holds the file)."""
    with open(path, "rb") as f:
        return _parse(bytearray(f.read()))

"""A reader and writer of the safetensors format, the package's own (the
``safetensors`` package is not a dependency of the port).

The format: an 8-byte little-endian header length ``N``, ``N`` bytes of a
JSON header, then the tensors' raw bytes. The header maps each tensor name
to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
bytes after the header) and may hold ``"__metadata__"``, a string-to-string
map. The header is padded with spaces to a multiple of 8 bytes, and the
data is one contiguous run with no holes, so the writer lays the tensors
out by element size, widest first (then by name), as the reference writer
does: every tensor then starts aligned to its element size.

* :func:`save_file` — writes atomically: a staging file next to the target
  through ``utils.durable_io`` (fsynced, with the path class's retries),
  then a rename. Tensors on the card are copied to the host first.
* :func:`load_file` — maps the file and copies each tensor out of the map
  straight to its device; :func:`read_header` reads the header alone.

Dtypes: F64, F32, F16, BF16, I64, I32, I16, I8, U8 and BOOL.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

from dlti_tpu_torch.utils import durable_io

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_CODES = {v: k for k, v in DTYPES.items()}
# A header larger than this is not a safetensors file (the reference's cap).
MAX_HEADER_BYTES = 100 * 1024 * 1024


class SafetensorsError(ValueError):
    """The file is not a well-formed safetensors file."""


def _nbytes(dtype: torch.dtype, shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def read_header(path: str) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """``(tensors, metadata, data_start)``: each tensor's header entry by
    name (in file order), the ``__metadata__`` map, and the byte offset at
    which the data begins."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise SafetensorsError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES:
            raise SafetensorsError(f"{path}: header of {n} bytes")
        raw = f.read(n)
    if len(raw) != n:
        raise SafetensorsError(f"{path}: truncated header")
    try:
        header = json.loads(raw)
    except ValueError as e:
        raise SafetensorsError(f"{path}: header is not JSON ({e})") from None
    meta = header.pop("__metadata__", None) or {}
    size = os.path.getsize(path) - 8 - n
    end = 0
    for name, entry in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        if entry.get("dtype") not in DTYPES:
            raise SafetensorsError(f"{path}: {name} has dtype {entry.get('dtype')!r}")
        lo, hi = entry["data_offsets"]
        if lo != end or hi - lo != _nbytes(DTYPES[entry["dtype"]], entry["shape"]):
            raise SafetensorsError(f"{path}: {name} has data offsets {lo}..{hi}")
        end = hi
    if end != size:
        raise SafetensorsError(f"{path}: {size} data bytes, the header indexes {end}")
    return header, meta, 8 + n


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, in file order, on ``device``. Each is
    copied out of a private map of the file, so the result owns its memory
    and the file may be replaced after."""
    header, _, start = read_header(path)
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    if not header:
        return out
    with open(path, "rb") as f:
        size = os.path.getsize(path)
        # ACCESS_COPY: a writable private view, which torch.frombuffer takes.
        mm = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)
    try:
        for name, entry in header.items():
            dtype = DTYPES[entry["dtype"]]
            lo, hi = entry["data_offsets"]
            shape = tuple(entry["shape"])
            if hi == lo:
                out[name] = torch.empty(shape, dtype=dtype, device=device)
                continue
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=hi - lo,
                                   offset=start + lo)
            if (start + lo) % torch.empty((), dtype=dtype).element_size():
                raw = raw.clone()  # misaligned for its dtype: align a copy
            t = raw.view(dtype).reshape(shape)
            out[name] = t.clone() if device.type == "cpu" else t.to(device)
            del raw, t
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mm.close()
    return out


def _host_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes as a flat buffer (copied to the host if it is on a
    card)."""
    t = t.detach().contiguous()  # a transpose is laid out where it lies
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None, *,
              path_class: str = "checkpoint") -> None:
    """Write ``tensors`` to ``path`` as one safetensors file, atomically.
    ``metadata`` becomes the header's ``__metadata__`` (strings only)."""
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code")
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    chunks = [struct.pack("<Q", len(raw)), raw]
    chunks += [_host_bytes(tensors[name]) for name in order
               if tensors[name].numel()]
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        durable_io.write_bytes(tmp, chunks, path_class=path_class)
        durable_io.replace(tmp, path, path_class=path_class)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    durable_io.fsync_dir(os.path.dirname(path))

"""Device resolution, the dtype-name table, and host<->device copies that
wait on the card at most once.

The dtype table is this package's copy of ``dlti_tpu/utils/dtypes.py``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r}; expected one of {sorted(_DTYPES)}"
        ) from None


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no argument and no CUDA this raises instead of quietly
    running on the CPU. A CUDA device always comes back with its index
    (``"cuda"`` means the current card), since ``torch.cuda.set_device``
    refuses one without."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def upload(a, device: torch.device, out: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """A host array (numpy) as a tensor on ``device`` (into ``out`` when
    given), without waiting on the device: on the card it is staged in
    pinned memory and copied with ``non_blocking=True``. The caching host
    allocator records the copy, so the pinned buffer is not handed out
    again before the copy has read it. A pageable upload would synchronize
    the stream."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory()
    elif out is None:
        t = t.clone()
    if out is not None:
        return out.copy_(t, non_blocking=True)
    return t.to(device, non_blocking=True)


def to_host(*tensors: torch.Tensor) -> list:
    """Tensors as numpy arrays (copies), with at most one wait on the card:
    each CUDA tensor is copied into pinned memory without blocking, then
    its stream is synchronized once."""
    out, stream = [], None
    for t in tensors:
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            stream = torch.cuda.current_stream(t.device)
            out.append(h)
        else:
            out.append(t.detach().clone())
    if stream is not None:
        stream.synchronize()
    return [h.numpy() for h in out]

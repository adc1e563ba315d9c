"""Device resolution and the dtype-name table.

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

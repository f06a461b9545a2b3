"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` and return it as a ``torch.device``.

    ``cuda`` (the default of every entry point) raises when PyTorch sees no
    CUDA device: the port never drops to the CPU on its own.  The CPU runs
    only when the caller asks for it, and then every kernel wrapper takes
    its plain PyTorch version.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain CPU path"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}")
    return table[name]

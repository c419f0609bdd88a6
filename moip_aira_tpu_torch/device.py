"""Device selection: a name in, a ``torch.device`` out, and nothing implicit.

The port never chooses a device on its own.  Asking for CUDA on a machine
without a usable card is an error, never a silent move to the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(spec: Union[str, torch.device]) -> torch.device:
    """Turn ``"cpu"``, ``"cuda"`` or ``"cuda:N"`` into a ``torch.device``.

    Raises RuntimeError if CUDA is asked for and is not available, and
    ValueError for any other device type."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")

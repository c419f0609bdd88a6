"""Registry of kernel-shaping env knobs: the single source of truth.

A copy of ``moip_aira_tpu/utils/knobs.py``.  Any ``MOIP_*`` environment
variable that changes what a kernel computes (buffer sizes, pivot rules,
per-node budgets) is read through :func:`get`, so every such knob is listed
here.  The reference folds this registry into its AOT executable cache key;
the port builds its kernels from source and has no such cache, but keeps
one list of the knobs.  ``MOIP_FRAG_VMEM_MB`` is not carried over: it only
sized the TPU's VMEM chunks.

Knobs that only change HOST behaviour (schedulers, tracing, budgets that
never reach a kernel) do not belong here.
"""

from __future__ import annotations

import os

#: knob -> canonical "unset" default used for cache-key hashing, so an
#: explicitly-set default (MOIP_FRAG_CAP=2048) and an unset knob key
#: identically
KERNEL_KNOBS = {
    "MOIP_FRAG_P1_STALL": "",
    "MOIP_FRAG_CAP": "2048",
    "MOIP_FRAG_NODE_ITERS": "",
}


def get(name: str, default: str | None = None) -> str:
    """Read a kernel-shaping knob; ``name`` must be registered above.

    ``default`` overrides the registry default for call sites whose
    fallback is computed at runtime (e.g. shape-dependent budgets); the
    registry still records the canonical unset form for hashing.
    """
    if name not in KERNEL_KNOBS:
        raise KeyError(
            f"{name} is not in utils.knobs.KERNEL_KNOBS — register it there"
        )
    val = os.environ.get(name)
    if val is not None:
        return val
    return KERNEL_KNOBS[name] if default is None else default

"""Host timing spans of the port.

``GLOBAL_TIMINGS`` is ``moip_aira_tpu.utils.trace``'s process-wide span
table (pure Python), which the wave backend and the reused host engines
fill: ``wave.device_lp``, ``wave.certify``, ``host.exact_lp`` and the
rest.  Named here so code that drives the port imports only
``moip_aira_tpu_torch``."""

from moip_aira_tpu.utils.trace import GLOBAL_TIMINGS

__all__ = ["GLOBAL_TIMINGS"]

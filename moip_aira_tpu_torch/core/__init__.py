from moip_aira_tpu_torch.core.store import Result, Solutions

__all__ = ["Result", "Solutions"]

from moip_aira_tpu_torch.engine.worker_spec import Cell, LockGroup, WorkerSpec
from moip_aira_tpu_torch.engine.scheduler import Scheduler

__all__ = ["Cell", "LockGroup", "WorkerSpec", "Scheduler"]

from moip_aira_tpu_torch.parallel.symgroup import sym_perms, max_workers

__all__ = ["sym_perms", "max_workers"]

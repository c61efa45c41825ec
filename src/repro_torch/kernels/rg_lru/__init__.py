from repro_torch.kernels.rg_lru import ops, ref

__all__ = ["ops", "ref"]

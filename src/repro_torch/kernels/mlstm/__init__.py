from repro_torch.kernels.mlstm import ops, ref

__all__ = ["ops", "ref"]

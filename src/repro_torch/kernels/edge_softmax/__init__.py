from repro_torch.kernels.edge_softmax import ops, ref

__all__ = ["ops", "ref"]

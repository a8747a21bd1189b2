from repro_torch.kernels.cooccur.ops import cooccurrence_matrix

__all__ = ["cooccurrence_matrix"]

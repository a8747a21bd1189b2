from repro_torch.kernels.nlist_intersect.ops import nlist_intersect

__all__ = ["nlist_intersect"]

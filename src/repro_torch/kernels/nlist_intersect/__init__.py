from repro_torch.kernels.nlist_intersect.ops import nlist_intersect, nlist_wave

__all__ = ["nlist_intersect", "nlist_wave"]

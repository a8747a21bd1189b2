from repro_torch.kernels.histogram.ops import item_histogram

__all__ = ["item_histogram"]

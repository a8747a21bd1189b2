"""The port's kernels: each ``<name>/`` holds ``kernel.py`` (the wrapper of
a hand-written CUDA kernel under ``repro_torch/csrc``), ``ref.py`` (its
plain PyTorch version) and ``ops.py`` (the public op). ``WRAPPERS`` maps
each kernel to its wrapper, whose ``.launches`` counts its launches
(B1/B2 count there also when the miner's wave entry, ``nlist_wave_cuda``,
launches them)."""
from repro_torch.kernels.cooccur.kernel import cooccur_cuda
from repro_torch.kernels.histogram.kernel import histogram_cuda
from repro_torch.kernels.nlist_intersect.kernel import (
    nlist_intersect_cuda,
    nlist_intersect_es_cuda,
    nlist_wave_cuda,
)

WRAPPERS = {
    "nlist_intersect": nlist_intersect_cuda,
    "nlist_intersect_es": nlist_intersect_es_cuda,
    "histogram": histogram_cuda,
    "cooccur": cooccur_cuda,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}

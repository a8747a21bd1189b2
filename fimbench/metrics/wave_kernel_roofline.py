"""The wave kernels' (B1/B2) share of their roofline over the traced
window. Time: the device time of every kernel whose name holds
``wave_kernel``, from the profiler's trace. Work: the program's
``wave.floor_bytes`` counter, the bytes of each launch that hold whatever
the data (every slot's state row and support written, the live index
columns read), under ``fimbench.roofline``'s bound. A floor of the true
bytes, so the share cannot pass 100%. Silent where either is missing."""
from fimbench import roofline, spans

KERNEL = "wave_kernel"


def read(run):
    if run.trace is None:
        return None
    floor = spans.table().get("wave.floor_bytes")
    seconds = sum(s for name, s in run.trace["op_s"].items() if KERNEL in name)
    if floor is None or seconds <= 0:
        return None
    return 100.0 * roofline.bound_s(floor["total"], 0) / seconds

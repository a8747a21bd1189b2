"""Device resolution shared by the port's entry points, and the stream
hand-over a mesh needs: one side stream per distinct CUDA device."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def side_streams(devices) -> list:
    """One new CUDA stream per distinct CUDA device in ``devices`` (none for
    the CPU, which has no streams)."""
    out, seen = [], set()
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d not in seen:
            seen.add(d)
            out.append(torch.cuda.Stream(d))
    return out


@contextlib.contextmanager
def on_streams(streams):
    """Make each of ``streams`` the current stream of its device."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


def record_ready(streams) -> tuple | None:
    """An event recorded on each of ``streams``, as ``(device, event)``
    pairs; None when there are no streams (the CPU)."""
    if not streams:
        return None
    out = []
    for s in streams:
        ev = torch.cuda.Event()
        ev.record(s)
        out.append((s.device, ev))
    return tuple(out)


def wait_ready(ready) -> None:
    """Order each device's current stream after its event in ``ready``."""
    for dev, ev in ready or ():
        torch.cuda.current_stream(dev).wait_event(ev)

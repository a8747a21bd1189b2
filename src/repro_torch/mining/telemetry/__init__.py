"""repro_torch.mining.telemetry — request trace spans (:mod:`.trace`): span
trees behind a ``failures``-style global attach/detach, exported as JSON or
Chrome trace events. With no recorder attached a span site costs one
global read. The reference's histograms and stats emitter come with the
serving layer."""
from .trace import TraceRecorder, active, attach, attached, current_span, span

__all__ = [
    "TraceRecorder",
    "active",
    "attach",
    "attached",
    "current_span",
    "span",
]

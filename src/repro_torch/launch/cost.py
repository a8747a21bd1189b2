"""A dispatch-level cost model of the port's eager programs: the
counterpart of the JAX package's ``launch/hlo_cost.py``.

``CostMode`` is a ``TorchDispatchMode``: every aten op the program
dispatches passes through it and is charged to the active ``Recorder``:

  flops      — 2·M·N·K for each ``mm``/``bmm``/``addmm``/``baddbmm``
               (einsum and ``linear`` reach these) and convolution, on the
               tensor cores when its operands are 16-bit or narrower, else
               as scalar operations; one operation per output element for
               the elementwise ops of the reference's ``_EW_FLOPS``;
  hbm bytes  — operand plus result bytes of every op that touches memory.
               Views, ``detach`` and ``empty*`` are free; a gather is
               charged its result twice plus its indices, a scatter its
               updates twice plus its indices, a copy its source twice.
               Eager PyTorch fuses nothing, so this is the eager program's
               traffic op by op, not XLA's post-fusion model;
  kernels    — the hand-written kernels are opaque to dispatch (``ctypes``
               launches). Each wrapper reports its own work (bytes, scalar
               operations) through ``charged``, and nothing it dispatches
               inside is charged, so the CUDA kernel and its plain version
               report the same cost for the same call;
  collectives — the port's cross-position moves and sums report their
               payload by the reference's op names through ``collective``,
               with the bytes that leave a position (``wire_bytes``).

Loops need no trip counts: eager execution unrolls every Python loop, so
each iteration is charged as it runs.

Work is charged to a mesh position. Everything runs on the mesh's first
position unless code names another with ``Recorder.at`` (the ZeRO-1 moment
blocks do); ``ProgramCost`` holds the busiest position's flops and bytes.

On the meta device (the dry-run's abstract trace) nothing is computed, and
an out-of-place op's result is made from the metadata of an earlier result
of the same op on the same metadata, which keeps a long trace (the sLSTM's
steps) fast. The mode also tracks the peak of the bytes the trace holds
live (``peak_bytes``), from each allocation to its tensor's release.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_local = threading.local()

# ops that allocate without touching memory, or only reshape metadata
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
    "_unsafe_view", "lift_fresh", "alias", "resize", "set", "_local_scalar_dense",
    "record_stream", "is_same_size", "_has_compatible_shallow_copy_type",
}
# the reference's _EW_FLOPS as aten names: one operation per output element
_EW = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "log", "tanh", "rsqrt",
    "sqrt", "pow", "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "bitwise_and", "bitwise_or", "neg", "abs", "floor", "sign", "expm1", "sigmoid", "clamp",
    "clamp_min", "clamp_max",
}
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
_SCATTER = {"index_put", "_index_put_impl", "scatter", "scatter_add", "index_add",
            "index_copy", "scatter_reduce", "masked_scatter"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm"}
_TENSOR_CORE = {torch.bfloat16, torch.float16, torch.int8, torch.uint8}


@dataclasses.dataclass
class ProgramCost:
    flops: float  # tensor-core FLOPs plus scalar operations
    hbm_bytes: float
    coll_payload: dict
    wire_bytes: float  # bytes that leave a mesh position
    mm_flops: float = 0.0  # the tensor-core share of ``flops``
    peak_bytes: int = 0  # the most bytes the traced program held live at once
    n_ops: int = 0  # aten ops dispatched


class Recorder:
    """Costs of one traced program, by mesh position (``None``: the first)."""

    def __init__(self):
        self.cost = defaultdict(lambda: [0.0, 0.0, 0.0])  # position -> [mm, scalar, bytes]
        self.coll_payload: dict[str, float] = defaultdict(float)
        self.wire_bytes = 0.0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._where = None
        self._quiet = 0  # > 0 inside a kernel wrapper: its ops are the kernel's
        self._scale = 1  # inside a folded loop body: its trip count

    def add(self, mm: float = 0.0, scalar: float = 0.0, nbytes: float = 0.0) -> None:
        c = self.cost[self._where]
        c[0] += mm * self._scale
        c[1] += scalar * self._scale
        c[2] += nbytes * self._scale

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Charge what runs inside ``n`` times (a folded loop's body)."""
        was = self._scale
        self._scale = was * n
        try:
            yield
        finally:
            self._scale = was

    @contextlib.contextmanager
    def at(self, position):
        """Charge what runs inside to ``position`` (hashable; ``None`` and an
        all-zero block coordinate are the mesh's first position)."""
        if position is not None and not any(position):
            position = None
        was, self._where = self._where, position
        try:
            yield
        finally:
            self._where = was

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def alloc(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        if n:
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n

    def program_cost(self) -> ProgramCost:
        from repro_torch.launch.roofline import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, SCALAR_OPS_PER_S

        def seconds(c):
            return max(c[0] / PEAK_BF16_FLOPS, c[1] / SCALAR_OPS_PER_S, c[2] / HBM_BYTES_PER_S)

        busiest = max(self.cost.values(), key=seconds, default=[0.0, 0.0, 0.0])
        return ProgramCost(flops=busiest[0] + busiest[1], hbm_bytes=busiest[2],
                           coll_payload=dict(self.coll_payload), wire_bytes=self.wire_bytes,
                           mm_flops=busiest[0], peak_bytes=self.peak, n_ops=self.n_ops)


def active() -> Recorder | None:
    """The recorder of the innermost ``rollup``/``trace`` on this thread."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def charged(cost_fn):
    """Decorate a kernel wrapper: with a recorder active, a call charges
    ``cost_fn(*args, **kw) -> (bytes, scalar_ops)`` (evaluated uncharged) and
    nothing the wrapper dispatches, whichever route (the CUDA kernel or the
    plain version) it takes; with none, it only runs."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            rec = active()
            if rec is None or rec._quiet:
                return fn(*args, **kw)
            with rec.quiet():
                nbytes, ops = cost_fn(*args, **kw)
                rec.add(scalar=ops, nbytes=nbytes)
                return fn(*args, **kw)
        return run
    return wrap


def collective(op: str, payload: float, wire: float) -> None:
    """Charge a cross-position move or sum: ``payload`` bytes under the
    reference's op name, ``wire`` of them leaving a position."""
    rec = active()
    if rec is not None and not rec._quiet and payload:
        rec.coll_payload[op] += payload * rec._scale
        rec.wire_bytes += wire * rec._scale


class _Fold(torch.autograd.Function):
    """One traced step charged as ``n``: forward, and in the backward the
    step's gradient (its forward recomputed uncharged, as the eager program
    keeps the step's activations or recomputes them under its own remat)."""

    @staticmethod
    def forward(ctx, n, rec, step, n_carry, *ins):
        ctx.n, ctx.rec, ctx.step, ctx.n_carry = n, rec, step, n_carry
        ctx.save_for_backward(*ins)
        with rec.scaled(n):
            carry, y = step(tuple(ins[:n_carry]), ins[n_carry], *ins[n_carry + 1:])
        return (*carry, y)

    @staticmethod
    def backward(ctx, *gouts):
        ins = [t.detach().requires_grad_(t.is_floating_point()) for t in ctx.saved_tensors]
        k = ctx.n_carry
        with torch.enable_grad():
            with ctx.rec.quiet():
                carry, y = ctx.step(tuple(ins[:k]), ins[k], *ins[k + 1:])
            pairs = [(o, g) for o, g in zip((*carry, y), gouts) if g is not None and o.requires_grad]
            need = [t for t in ins if t.requires_grad]
            with ctx.rec.scaled(ctx.n):
                got = iter(torch.autograd.grad([o for o, _ in pairs], need, [g for _, g in pairs],
                                               allow_unused=True))
        return (None, None, None, None, *(next(got) if t.requires_grad else None for t in ins))


def scan(step, carry: tuple, xs, consts: tuple = ()):
    """``for x in xs: carry, y = step(carry, x, *consts)``, collecting each
    ``y``. -> (carry, [y, ...]).

    In the dry-run's abstract trace (a recorder active, the carry on the
    meta device) every step has the same shapes and so the same cost, and
    nothing is computed: the step runs once, charged ``len(xs)`` times in
    the forward and in the backward, and its ``y`` stands for every step's.
    This is the reference's ``known_trip_count`` rollup of a ``scan``;
    without it the trace of a 32k-step recurrence dispatches millions of
    ops. Everywhere else the loop runs as written."""
    rec = active()
    if rec is None or not carry or carry[0].device.type != "meta" or len(xs) < 2:
        ys = []
        for x in xs:
            carry, y = step(carry, x, *consts)
            ys.append(y)
        return carry, ys
    out = _Fold.apply(len(xs), rec, step, len(carry), *carry, xs[0], *consts)
    return tuple(out[:-1]), [out[-1]] * len(xs)


def uncharged():
    """Charge nothing of what runs inside (set-up that is no work of the
    traced program)."""
    rec = active()
    return rec.quiet() if rec is not None else contextlib.nullcontext()


def at(position):
    """``Recorder.at`` of the active recorder; a no-op without one."""
    rec = active()
    return rec.at(position) if rec is not None else contextlib.nullcontext()


def _flat(*trees) -> list:
    """The leaves of (nested) tuples, lists and dicts."""
    out = []
    stack = list(reversed(trees))
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        else:
            out.append(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _base_name(func) -> str:
    name = func._schema.name.split("::")[-1]
    return name[:-1] if name.endswith("_") else name  # an in-place op is charged as its own


class CostMode(TorchDispatchMode):
    """Charges every dispatched aten op to ``rec`` (see the module
    docstring)."""

    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec
        self._kind: dict = {}  # func -> (base name, free, mutates, cacheable)
        self._meta_out: dict = {}  # (func, argument metadata) -> result metadata

    def _classify(self, func):
        k = self._kind.get(func)
        if k is None:
            s = func._schema
            name = _base_name(func)
            view = any(r.alias_info is not None and not r.alias_info.is_write for r in s.returns)
            mutates = s.is_mutable
            tensors_out = bool(s.returns) and all(str(r.type) in ("Tensor", "Tensor[]") for r in s.returns)
            free = view or name in _FREE or not tensors_out
            cacheable = tensors_out and not view and not mutates
            k = self._kind[func] = (name, free, mutates, cacheable)
        return k

    def _run(self, func, args, kwargs, flat, cacheable):
        """``func``'s result; on meta inputs, from the metadata memo."""
        key = None
        if cacheable:
            parts = [func]
            meta = False
            for a in flat:
                if isinstance(a, torch.Tensor):
                    if a.device.type != "meta":
                        parts = None
                        break
                    meta = True
                    parts.append((a.shape, a.stride(), a.dtype))
                elif a is None or isinstance(a, (int, float, bool, str, torch.dtype, torch.device,
                                                 torch.layout, torch.memory_format)):
                    parts.append(a)
                else:
                    parts = None
                    break
            if parts is not None and meta:
                key = tuple(parts)
                hit = self._meta_out.get(key)
                if hit is not None:
                    made = [torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in hit[0]]
                    return made[0] if hit[1] is None else hit[1](made)
        out = func(*args, **kwargs)
        if key is not None:
            outs = [out] if isinstance(out, torch.Tensor) else out
            if isinstance(outs, (tuple, list)) and all(isinstance(o, torch.Tensor) for o in outs):
                self._meta_out[key] = ([(o.shape, o.stride(), o.dtype) for o in outs],
                                       None if isinstance(out, torch.Tensor) else type(out))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if rec._quiet:
            return func(*args, **kwargs)
        name, free, mutates, cacheable = self._classify(func)
        flat = _flat(args, kwargs) if cacheable or not free else ()
        out = self._run(func, args, kwargs, flat, cacheable)
        rec.n_ops += 1
        if free:
            return out
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        outs = [o for o in _flat(out) if isinstance(o, torch.Tensor)]
        in_b = sum(_nbytes(a) for a in ins)
        out_b = sum(_nbytes(o) for o in outs)
        if name in _GATHER and ins:
            nbytes = 2 * out_b + in_b - _nbytes(ins[0])
        elif name in _SCATTER and ins:
            nbytes = 2 * (in_b - _nbytes(ins[0]))
        elif name == "copy" and len(ins) >= 2:
            nbytes = 2 * _nbytes(ins[1])
        else:
            nbytes = in_b + out_b
        mm = scalar = 0.0
        if name in _MATMUL and len(ins) >= 2:
            a, b = ins[-2], ins[-1]
            f = 2.0 * a.numel() * b.shape[-1]
            if a.dtype in _TENSOR_CORE:
                mm = f
            else:
                scalar = f
        elif name == "convolution" and len(ins) >= 2:
            w = ins[1]
            f = 2.0 * sum(o.numel() for o in outs) * (w.numel() // w.shape[0])
            if w.dtype in _TENSOR_CORE:
                mm = f
            else:
                scalar = f
        elif name in _EW or (name == "_to_copy" and outs and ins and outs[0].dtype != ins[0].dtype):
            scalar = float(sum(o.numel() for o in outs))
        rec.add(mm, scalar, nbytes)
        if not mutates:
            for o in outs:
                rec.alloc(o)
        return out


@contextlib.contextmanager
def recording(rec: Recorder | None = None):
    """Make ``rec`` (a new one by default) the active recorder and charge
    every op dispatched inside to it. -> the recorder."""
    rec = rec if rec is not None else Recorder()
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(rec)
    try:
        with CostMode(rec):
            yield rec
    finally:
        stack.pop()


def trace(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` under a fresh recorder. -> (its result, the
    ``ProgramCost``)."""
    with recording() as rec:
        out = fn(*args, **kw)
    return out, rec.program_cost()


def rollup(fn, *args, **kw) -> ProgramCost:
    """The ``ProgramCost`` of ``fn(*args, **kw)``, run once eagerly."""
    return trace(fn, *args, **kw)[1]

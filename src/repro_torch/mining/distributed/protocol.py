"""Wire protocol for the coordinator <-> worker RPC: length-prefixed
pickle frames over a stream socket, plus the op vocabulary.

Framing is the classic 8-byte big-endian length header followed by a
pickle payload (numpy arrays ride pickle's buffer protocol — no
re-encoding). Frames carry NumPy arrays and Python scalars only, never a
``torch.Tensor``: unpickling a CUDA tensor needs a CUDA device on the
receiving side, and a worker's tensors live in its own CUDA context.
Every request carries a per-worker monotonically increasing
``seq``; the worker echoes it in the reply. That one field is what makes
failover clean: when a query aborts mid-pipeline (another worker died),
surviving workers may still owe replies for waves the coordinator will
never use — the next request's reply is found by *skipping* frames with a
smaller ``seq`` instead of desynchronizing the channel.

Ops (all request dicts carry ``op`` and ``seq``):

  - ``hello``     worker -> coordinator, once, after dialing in
  - ``prep``      build one segment (snapshot-first) from rows + imposed order
  - ``query_begin``  reset wave state; carries the global rank->item order
  - ``wave``      one planned wave: the ``(3, Cpad)`` int64 index rows
                  ``idx``, each candidate group's ``live`` slots and the
                  ``local`` flag; the reply's ``sups`` (int64) sums the
                  worker's per-segment supports — its partial reduce
  - ``drop``      forget segments (window expiry, migration)
  - ``query_end`` drop wave state
  - ``ping``      heartbeat
  - ``stats``     worker telemetry (seg_prepares / snapshot hits / ...)
                  plus ``launches``, the worker process's kernel launch
                  counters (they live in that process)
  - ``inject``    arm a deterministic fault (die on the nth matching op)
  - ``shutdown``  orderly exit
"""
from __future__ import annotations

import pickle
import socket
import struct

_HEADER = struct.Struct(">Q")
MAX_FRAME = 1 << 34  # 16 GiB: sanity bound against corrupt headers

OP_HELLO = "hello"
OP_PREP = "prep"
OP_QUERY_BEGIN = "query_begin"
OP_WAVE = "wave"
OP_QUERY_END = "query_end"
OP_PING = "ping"
OP_STATS = "stats"
OP_INJECT = "inject"
OP_SHUTDOWN = "shutdown"


class ProtocolError(RuntimeError):
    """Malformed frame or out-of-order reply."""


class ConnectionClosed(ProtocolError):
    """Peer went away (EOF / reset) — the fast worker-death signal."""


def send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        try:
            chunk = sock.recv(min(n, 1 << 20))
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ConnectionClosed(str(e)) from e
        if not chunk:
            raise ConnectionClosed("peer closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket):
    (n,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if n > MAX_FRAME:
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME")
    return pickle.loads(_recv_exact(sock, n))

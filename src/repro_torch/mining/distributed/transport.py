"""Socket plumbing for the RPC layer: a ``Listener`` the coordinator
binds on loopback, ``dial`` for workers to connect back, and a ``Channel``
wrapping one connected socket with framed send/recv (``protocol``).

Loopback TCP rather than multiprocessing pipes on purpose: the framing +
dial-in shape is exactly what a multi-host deployment needs — moving a
worker to another machine changes the address, not the protocol.
"""
from __future__ import annotations

import socket
import threading
import time

from repro_torch.fault import failures
from repro_torch.mining.distributed.protocol import ConnectionClosed, recv_msg, send_msg


def _harden(sock: socket.socket) -> None:
    """Socket-level liveness: TCP_NODELAY (small RPC frames must not sit
    in Nagle buffers) plus SO_KEEPALIVE with aggressive probe timing where
    the platform exposes it, so a silently-dropped peer (power loss,
    network partition — no FIN ever arrives) surfaces as an ``OSError`` on
    the next blocking recv instead of hanging forever. The TCP_KEEP*
    constants are Linux-specific; elsewhere keepalive runs with kernel
    defaults (hours), and the per-call recv timeouts above carry liveness."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 10), ("TCP_KEEPCNT", 3)):
        if hasattr(socket, opt):
            try:
                sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)
            except OSError:
                pass


class Channel:
    """One connected peer. ``send`` is locked (heartbeat and caller
    threads may both write); ``recv`` is single-consumer by design.

    Both directions carry chaos points (``rpc.send`` / ``rpc.recv``): an
    installed injector can fail any frame with any exception type, which
    is how the soak proves the coordinator's timeout/retry/failover
    ladder without real packet loss."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        _harden(self.sock)
        self._send_lock = threading.Lock()
        self._closed = False

    def send(self, obj) -> None:
        with self._send_lock:
            if self._closed:
                raise ConnectionClosed("channel closed")
            failures.fire("rpc.send")  # chaos: frame lost on the way out
            try:
                send_msg(self.sock, obj)
            except (ConnectionResetError, BrokenPipeError, OSError) as e:
                raise ConnectionClosed(str(e)) from e

    def recv(self, timeout: float | None = None):
        failures.fire("rpc.recv")  # chaos: reply lost / delayed past timeout
        self.sock.settimeout(timeout)
        try:
            return recv_msg(self.sock)
        except socket.timeout as e:
            raise TimeoutError("rpc reply timed out") from e
        except OSError as e:
            raise ConnectionClosed(str(e)) from e

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class Listener:
    """Coordinator-side accept socket on an OS-assigned loopback port."""

    def __init__(self, host: str = "127.0.0.1"):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, 0))
        self.sock.listen(64)
        self.address: tuple[str, int] = self.sock.getsockname()

    def accept(self, timeout: float | None = None) -> Channel:
        self.sock.settimeout(timeout)
        try:
            conn, _ = self.sock.accept()
        except socket.timeout as e:
            raise TimeoutError("no worker dialed in before the deadline") from e
        return Channel(conn)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def dial(address: tuple[str, int], *, timeout: float = 30.0) -> Channel:
    """Worker-side connect with retry (the coordinator's listener is up
    before workers spawn, so retries only cover transient refusals)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(address, timeout=5.0)
            sock.settimeout(None)
            return Channel(sock)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)

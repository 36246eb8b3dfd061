"""Pose streaming server and client: the live demo's transport.

Counterpart of `pulse_tpu/utils/pose_server.py` (≙ the reference's
websocket server mode, base_task.py:254-316, and its pose-driven demo
clients): a background TCP thread streams newline-delimited JSON frames to
connected viewers and queues the commands (driving poses, clip switches)
they send. The wire format is the JAX package's byte for byte, so a client
of either package talks to a server of the other.

Standard library only (socket + threading).
"""

from __future__ import annotations

import json
import queue
import socket
import threading


def _line(obj: dict) -> bytes:
    return (json.dumps(obj) + "\n").encode()


class PoseServer:
    """Non-blocking broadcast server; call `publish(frame_dict)` per step.
    Port 0 binds a free port, which `port` then names."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8765):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._clients: list[socket.socket] = []
        self._inbox: "queue.Queue[dict]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        self._sock.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setblocking(True)
            self._clients.append(conn)
            threading.Thread(target=self._recv_loop, args=(conn,), daemon=True).start()

    def _recv_loop(self, conn: socket.socket):
        buf = b""
        while not self._stop.is_set():
            try:
                data = conn.recv(65536)
            except OSError:
                return
            if not data:
                return
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                try:
                    self._inbox.put(json.loads(line))
                except json.JSONDecodeError:
                    pass

    @property
    def num_clients(self) -> int:
        return len(self._clients)

    def publish(self, frame: dict) -> None:
        payload = _line(frame)
        dead = []
        for c in list(self._clients):
            try:
                c.sendall(payload)
            except OSError:
                dead.append(c)
        for c in dead:
            self._clients.remove(c)

    def poll_command(self) -> dict | None:
        """Latest driving pose/command from any client, if one arrived."""
        cmd = None
        while not self._inbox.empty():
            cmd = self._inbox.get_nowait()
        return cmd

    def close(self) -> None:
        self._stop.set()
        for c in self._clients:
            c.close()
        self._sock.close()
        self._thread.join(timeout=1.0)


class PoseClient:
    """Blocking line-JSON client (≙ the reference's scripts/ws_client.py).
    With `timeout` (seconds) a connect or a `recv` that waits longer raises
    `socket.timeout`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8765, timeout: float | None = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    def send(self, obj: dict) -> None:
        self._sock.sendall(_line(obj))

    def recv(self) -> dict:
        while b"\n" not in self._buf:
            data = self._sock.recv(65536)
            if not data:
                raise ConnectionError("server closed")
            self._buf += data
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def close(self) -> None:
        self._sock.close()

"""Stream opening helpers (port of ``ofps_tpu.decoders.io_utils``).

``tcp://addr:port`` connects, ``tcp://@:port`` (or ``tcp://@addr:port``)
listens and accepts one connection, anything else is a regular file path.
"""

from __future__ import annotations

import socket
from typing import BinaryIO


def open_stream(input_path: str) -> BinaryIO:
    if input_path.startswith("tcp://"):
        spec = input_path[len("tcp://") :]
        addr, _, port_s = spec.partition(":")
        if not port_s:
            raise ValueError(f"invalid tcp spec {input_path!r} (need addr:port)")
        port = int(port_s)
        if addr.startswith("@"):
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((addr[1:] or "0.0.0.0", port))
            listener.listen(1)
            sock, _ = listener.accept()
            listener.close()
        else:
            sock = socket.create_connection((addr, port))
        return sock.makefile("rb")
    return open(input_path, "rb")

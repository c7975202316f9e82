"""Shared fixtures for the PyTorch port's CPU parity tests.

Import the fixture into a test module to apply it there (autouse).
"""

import os

import pytest
import torch

_NO_PROXY = ("no_proxy", "NO_PROXY")


@pytest.fixture(autouse=True)
def single_torch_thread():
    # With JAX in the same process, torch's multi-threaded CPU kernels have
    # returned wrong values for one thread's share of the elements on a
    # first call (torch.sqrt off by ~2**-12 relative); one thread is exact.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread_module():
    # For a module whose shared fixtures build pipelines: a worker thread
    # keeps the torch thread count in force when it first ran an op, so
    # the count is set before the module-scoped fixtures start any.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class LocalServer:
    """An HTTP server on 127.0.0.1 in a thread, for download tests that
    must not leave the machine. ``routes`` maps a path to a list of
    ``(status, body)`` answers, served in turn, the last one repeated;
    ``requests`` records ``(path, User-Agent)`` of each GET."""

    def __init__(self, routes):
        import http.server
        import threading

        answers = {path: list(replies) for path, replies in routes.items()}
        requests = self.requests = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                requests.append((self.path, self.headers.get("User-Agent")))
                replies = answers.get(self.path, [(404, b"")])
                status, body = (replies.pop(0) if len(replies) > 1
                                else replies[0])
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                       Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def url(self, path):
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}{path}"

    def __enter__(self):
        # Requests to the server bypass any proxy the environment names.
        self._saved = {k: os.environ.get(k) for k in _NO_PROXY}
        os.environ.update(dict.fromkeys(_NO_PROXY, "127.0.0.1,localhost"))
        self._thread.start()
        return self

    def __exit__(self, *exc):
        for key, value in self._saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()


def refused_url(path="/x.pth"):
    """A URL on 127.0.0.1 whose port refuses connections."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return f"http://127.0.0.1:{port}{path}"


def with_url(monkeypatch, ckpt_module, checkpoint_id, url):
    """Point ``checkpoint_id``'s registry entry in ``ckpt_module`` at
    ``url``, on a copy of the registry."""
    monkeypatch.setattr(ckpt_module, "CHECKPOINTS", [
        dict(c, url=url) if c["id"] == checkpoint_id else c
        for c in ckpt_module.CHECKPOINTS
    ])


@pytest.fixture
def offline_registries(monkeypatch):
    """Point every entry of both packages' checkpoint registries at a
    refused port on 127.0.0.1, so that no test downloads from the
    reference's release URLs."""
    from terran_tpu import checkpoint as jax_ckpt
    from terran_tpu_torch import checkpoint as ckpt

    base = refused_url("")
    for module in (ckpt, jax_ckpt):
        monkeypatch.setattr(module, "CHECKPOINTS", [
            dict(c, url=f"{base}/{c['id']}.pth") for c in module.CHECKPOINTS
        ])

"""The port's local chat app, `cli.desktop` (CPU), as tests/test_desktop.py
holds the JAX one: the page over HTTP with the model socket's port filled
in, and one turn over a live localhost WebSocket to the port's
BackendServer, read to its "<eos>"."""

import asyncio
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from lmrs_tpu_torch.cli.desktop import PAGE, _PageHandler, build_argparser, main
from lmrs_tpu_torch.serve.backend import BackendServer
from test_torch_backend import artifacts  # noqa: F401  (fixture)

torch.set_num_threads(1)


def test_desktop_page_names_the_model_socket(monkeypatch):
    monkeypatch.setattr(_PageHandler, "ws_port", 5123)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _PageHandler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}",
                                    timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/html")
            page = r.read().decode()
    finally:
        httpd.shutdown()
        thread.join(10)
    assert page.startswith("<!DOCTYPE html>") and "WebSocket" in page
    assert "const WS_PORT = 5123;" in page and "__WS_PORT__" not in page
    assert page == PAGE.replace("__WS_PORT__", "5123")


def test_desktop_socket_turn(artifacts):  # noqa: F811
    websockets = pytest.importorskip("websockets")
    model_path, tok_path = artifacts
    server = BackendServer(model_path, tok_path, temperature=0.0,
                           max_new_tokens=12, device="cpu")

    async def run():
        async with websockets.serve(server.handle, "127.0.0.1", 0) as srv:
            port = list(srv.sockets)[0].getsockname()[1]
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                await ws.send(json.dumps({"text": "hi"}))
                got = []
                while True:
                    msg = json.loads(await asyncio.wait_for(ws.recv(), 60))
                    got.append(msg)
                    if (msg["category"] == "OUTPUT"
                            and msg["text"] == "<eos>"):
                        return got

    got = asyncio.run(run())
    assert [m["category"] for m in got] == ["OUTPUT"] * len(got)
    assert len(got) >= 2


def test_desktop_flags_are_the_backends():
    args = build_argparser().parse_args(
        ["--model", "m.lmrs", "--port", "8081", "--ws-port", "5001",
         "--batch", "4", "--cache-dtype", "int8", "--no-paged", "--device",
         "cpu"])
    assert (args.port, args.ws_port, args.batch, args.cache_dtype,
            args.no_paged, args.device) == (8081, 5001, 4, "int8", True,
                                            "cpu")
    assert (args.tp, args.cp, args.dp) == (1, 1, 1)


@pytest.mark.parametrize("flag", ["--tp", "--cp"])
def test_desktop_tp_and_cp_are_not_ported_yet(artifacts, flag):  # noqa: F811
    """--tp and --cp reach the backend: combined with --dp they raise the
    JAX backend's ValueErrors (--dp needs --batch; --dp refuses --cp)
    before any rank starts."""
    model_path, tok_path = artifacts
    extra, match = ((["--batch", "2"], "--dp with --cp") if flag == "--cp"
                    else ([], "--dp requires --batch"))
    with pytest.raises(ValueError, match=match):
        main(["--model", model_path, "--tokenizer", tok_path, flag, "2",
              "--dp", "2", "--device", "cpu"] + extra)

"""The port's WebSocket backend (`serve.backend.BackendServer`, CPU): lm.rs's
JSON text protocol over an in-process connection (any object with an
async `send` and async iteration), single-stream and --batch (paged and
contiguous), as tests/test_backend.py holds the JAX backend over a live
server; one test runs a live localhost server where the `websockets`
package is installed.

Tolerance: greedy replies text for text between the single-stream engine
and the batched scheduler (token for token: tests/test_torch_scheduler.py).
"""

import asyncio
import base64
import io
import json
import string

import pytest
import torch

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import write_lmrs
from lmrs_tpu_torch.io.synthetic import random_weights, tiny_config
from lmrs_tpu_torch.serve.backend import (CAPACITY, CONTEXT_FULL,
                                          IMAGE_STATUS, IMAGE_UNREADABLE,
                                          BackendServer, main)
from lmrs_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

VOCAB = 2560


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("backend")
    # Gemma: its chat-format ids (up to 2516) fit a small vocabulary
    cfg = tiny_config(ModelType.GEMMA, QuantType.Q8_0, vocab_size=VOCAB,
                      head_dim=128, n_heads=2, n_kv_heads=2, dim=128,
                      hidden_dim=256, n_layers=2, seq_len=256)
    model_path = str(d / "m.lmrs")
    write_lmrs(model_path, cfg, random_weights(cfg, 2))
    vocab = ["<pad>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    vocab += list(" " + string.ascii_letters + ".,!?")
    vocab += ["~"] * (VOCAB - len(vocab))
    tok_path = str(d / "tok.bin")
    Tokenizer(vocab, [0.0] * len(vocab), 1, 2).save(tok_path)
    return model_path, tok_path


class Conn:
    """An in-process connection: yields `incoming` (after `gate`, if
    given, is set) and records what the server sends."""

    def __init__(self, incoming, gate=None):
        self.incoming = list(incoming)
        self.sent = []
        self.gate = gate

    async def send(self, msg):
        self.sent.append(json.loads(msg))

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        if self.gate is not None:
            await self.gate.wait()
        for m in self.incoming:
            yield m
            await asyncio.sleep(0)


def server(artifacts, **kw):
    model_path, tok_path = artifacts
    kw.setdefault("max_new_tokens", 12)
    return BackendServer(model_path, tok_path, temperature=0.0,
                         device="cpu", **kw)


def replies(conn):
    """The OUTPUT texts of each turn (split at "<eos>") and the STATUS
    lines."""
    turns, cur, status = [], [], []
    for m in conn.sent:
        if m["category"] == "STATUS":
            status.append(m["text"])
        elif m["text"] == "<eos>":
            turns.append("".join(cur))
            cur = []
        else:
            cur.append(m["text"])
    return turns, status


def talk(srv, *convs):
    async def go():
        await asyncio.gather(*(srv.handle(c) for c in convs))
    asyncio.run(go())
    return [replies(c) for c in convs]


MSGS = [json.dumps({"text": "Hello there"}),
        json.dumps({"text": "And again?"})]


@pytest.fixture(scope="module")
def single_replies(artifacts):
    srv = server(artifacts)
    (turns, status), = talk(srv, Conn(MSGS))
    return turns, status


def test_protocol_single_stream(single_replies):
    turns, status = single_replies
    assert len(turns) == 2 and not status
    assert all(isinstance(t, str) for t in turns)


@pytest.mark.parametrize("mode", [dict(batch=2),
                                  dict(batch=2, no_paged=True),
                                  dict(batch=2, cache_dtype="int8")])
def test_batched_replies_match_single_stream(artifacts, single_replies,
                                             mode):
    """Two connections decode together, each in its own leased slot, and
    each reads the single-stream engine's greedy replies (the int8 cache:
    its own single-stream replies)."""
    want = single_replies[0]
    if mode.get("cache_dtype") == "int8":
        (want, _), = talk(server(artifacts, cache_dtype="int8"), Conn(MSGS))
    srv = server(artifacts, **mode)
    try:
        sched = srv.scheduler.sched
        assert sched.paged == (not mode.get("no_paged"))
        a, b = Conn(MSGS), Conn(MSGS)
        (ta, sa), (tb, sb) = talk(srv, a, b)
        assert ta == want and tb == want and not sa and not sb
        # both conversations ended: their slots are free again
        assert all(s.lease is None for s in sched.slots)
    finally:
        srv.shutdown()


def test_capacity_and_bad_frames(artifacts):
    """With one slot, a second conversation that arrives while the first
    holds it is told the server is at capacity; malformed frames are
    skipped."""
    srv = server(artifacts, batch=1)
    try:
        async def go():
            gate = asyncio.Event()
            first = Conn([b"\xff\xfe", "not json", json.dumps({"x": 1}),
                          MSGS[0]], gate=gate)
            task = asyncio.ensure_future(srv.handle(first))
            await asyncio.sleep(0.05)        # the first holds the slot
            second = Conn(MSGS)
            await srv.handle(second)
            gate.set()
            await task
            return first, second
        first, second = asyncio.run(go())
        assert replies(second) == ([], [CAPACITY])
        turns, status = replies(first)
        assert len(turns) == 1 and not status
    finally:
        srv.shutdown()


@pytest.mark.parametrize("batch", [0, 1])
def test_context_full(artifacts, batch):
    srv = server(artifacts, batch=batch, max_ctx=32 if batch else None)
    try:
        long = json.dumps({"text": "x" * 300})
        (turns, status), = talk(srv, Conn([long]))
        assert status == [CONTEXT_FULL] and turns == [""]
    finally:
        srv.shutdown()


def test_unsupported_options_raise(artifacts):
    """The JAX backend's invalid combinations of --tp/--cp/--dp raise its
    ValueErrors before any rank starts (`test_mesh_flags_serve` serves the
    valid ones)."""
    model_path, tok_path = artifacts
    for kw, match in ((dict(pool_tokens=512), "requires --batch"),
                      (dict(pool_tokens=512, batch=2, cp=2),
                       "--cp is not supported"),
                      (dict(dp=2), "--dp requires --batch"),
                      (dict(dp=2, batch=2, cp=2), "--dp with --cp"),
                      (dict(tp=3), "tp=3 incompatible")):
        with pytest.raises(ValueError, match=match):
            BackendServer(model_path, tok_path, device="cpu", **kw)
    # a text-only server answers the text of a message with an image, as
    # the JAX BackendServer does on the same model (greedy, text for text)
    image_msg = json.dumps({"text": "Hello there", "image": "AAAA"})
    (turns, status), = talk(server(artifacts), Conn([image_msg]))
    assert not status and turns == [jax_reply(artifacts, image_msg)]
    with pytest.raises(ValueError, match="--dp requires --batch"):
        main(["--model", model_path, "--tokenizer", tok_path, "--device",
              "cpu", "--tp", "2", "--dp", "2"])


@pytest.mark.parametrize("mode", [dict(tp=2), dict(cp=2),
                                  dict(batch=2, tp=2),
                                  dict(batch=2, cp=2, no_paged=True),
                                  dict(batch=2, dp=2)])
def test_mesh_flags_serve(artifacts, single_replies, mode):
    """--tp and --cp reach a mesh (two rank processes on the CPU) under
    each connection's Engine or under the one scheduler, and --dp a router
    of two scheduler replicas, each on its own SchedulerThread: two
    conversations read the single-stream engine's greedy replies, text for
    text."""
    srv = server(artifacts, **mode)
    try:
        if mode.get("dp"):
            assert srv.router is not None and len(srv.threads) == 2
        else:
            assert (srv.mesh.tp, srv.mesh.cp) == (mode.get("tp", 1),
                                                  mode.get("cp", 1))
        if mode.get("batch") and not mode.get("dp"):
            assert srv.scheduler.sched.mesh is srv.mesh
            assert srv.scheduler.sched.paged == (not mode.get("cp"))
        (ta, sa), (tb, sb) = talk(srv, Conn(MSGS), Conn(MSGS))
        assert ta == single_replies[0] and tb == single_replies[0]
        assert not sa and not sb
    finally:
        srv.shutdown()


def jax_reply(artifacts, msg):
    """The JAX BackendServer's greedy reply to one message on the same
    .lmrs file and tokenizer (12 new tokens, as `server` gives)."""
    from lmrs_tpu.serve.backend import BackendServer as JaxBackendServer

    model_path, tok_path = artifacts
    jsrv = JaxBackendServer(model_path, tok_path, temperature=0.0,
                            max_new_tokens=12)
    (turns, status), = talk(jsrv, Conn([msg]))
    assert not status
    return turns[0]


@pytest.mark.parametrize("batch", [0, 2])
def test_lmrs_w8a8_off_reaches_engine_and_scheduler(artifacts, monkeypatch,
                                                    batch):
    """LMRS_W8A8=0, the switch the chat CLI reads, sends the backend's Q8_0
    layers through W8A16 too: the scheduler and every connection's Engine
    hold w8a8=False, and the greedy reply is Engine(w8a8=False)'s, text
    for text."""
    from lmrs_tpu_torch.runtime import engine as engine_mod
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
    from lmrs_tpu_torch.tokenizer import StreamDecoder

    made = []

    class Recording(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setenv("LMRS_W8A8", "0")
    monkeypatch.setattr(engine_mod, "Engine", Recording)
    srv = server(artifacts, batch=batch)
    try:
        assert srv.w8a8 is False
        (turns, _), = talk(srv, Conn(MSGS[:1]))
        if batch:
            assert srv.scheduler.sched.w8a8 is False
        else:
            assert made and all(e.w8a8 is False for e in made)
    finally:
        srv.shutdown()
    eng = Engine(srv.cfg, srv.params, device="cpu", w8a8=False,
                 prefill_chunk=256)
    stop = srv._stop_tokens()
    toks = eng.generate(srv._prompt("Hello there", True),
                        GenerationConfig(temperature=0.0, max_new_tokens=12),
                        stop_tokens=stop)
    dec = StreamDecoder(srv.tokenizer)
    want = "".join(dec.push(t) or "" for t in toks if t not in stop)
    assert turns == [want + (dec.flush() or "")]


def test_live_websocket_server(artifacts, single_replies):
    """The protocol over a live localhost server (`serve` path)."""
    websockets = pytest.importorskip("websockets")
    srv = server(artifacts, batch=2)
    try:
        async def go():
            async with websockets.serve(srv.handle, "127.0.0.1", 0) as ws:
                port = ws.sockets[0].getsockname()[1]
                async with websockets.connect(
                        f"ws://127.0.0.1:{port}") as c:
                    out = []
                    for m in MSGS:
                        await c.send(m)
                        while True:
                            r = json.loads(await c.recv())
                            if r["text"] == "<eos>":
                                break
                            out.append(r["text"])
                        out.append("|")
                    return "".join(out).split("|")[:-1]
        assert asyncio.run(go()) == single_replies[0]
    finally:
        srv.shutdown()


def _tokenizer_file(path, size):
    vocab = ["<pad>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    vocab += list(" " + string.ascii_letters + ".,!?")
    vocab += ["~"] * (size - len(vocab))
    Tokenizer(vocab, [0.0] * len(vocab), 1, 2).save(path)
    return path


@pytest.fixture(scope="module")
def mm_artifacts(tmp_path_factory):
    """A tiny Phi-3.5-vision file (tests/test_torch_multimodal.py), its
    tokenizer, and one message with a PNG image."""
    from PIL import Image

    from test_torch_multimodal import image, write_tiny_mm

    d = tmp_path_factory.mktemp("mm_backend")
    model_path = write_tiny_mm(str(d / "mm.lmrs"))
    tok_path = _tokenizer_file(str(d / "tok.bin"), 32064)
    buf = io.BytesIO()
    Image.fromarray(image(2, (90, 60, 3))).save(buf, format="PNG")
    msg = json.dumps({"text": "What is in the image?",
                      "image": base64.b64encode(buf.getvalue()).decode()})
    return model_path, tok_path, msg


@pytest.mark.parametrize("batch", [0, 2])
def test_multimodal_image_turn_matches_jax_backend(mm_artifacts, batch):
    """--multimodal, single stream and --batch 2: FEATURE at connect, the
    three image STATUS lines, then the JAX backend's greedy replies to the
    image turn and to a text turn after it, text for text."""
    from lmrs_tpu.serve.backend import BackendServer as JaxBackendServer

    model_path, tok_path, msg = mm_artifacts
    convo = [msg, MSGS[1]]
    jsrv = JaxBackendServer(model_path, tok_path, temperature=0.0,
                            max_new_tokens=8, multimodal=True)
    jconn = Conn(convo)
    talk(jsrv, jconn)
    srv = BackendServer(model_path, tok_path, temperature=0.0,
                        max_new_tokens=8, multimodal=True, batch=batch,
                        device="cpu")
    try:
        conn = Conn(convo)
        (turns, status), = talk(srv, conn)
    finally:
        srv.shutdown()
    assert conn.sent[0] == {"category": "FEATURE", "text": "multimodal"}
    assert jconn.sent[0] == conn.sent[0]
    assert status == list(IMAGE_STATUS) == replies(jconn)[1]
    assert len(turns) == 2 and turns == replies(jconn)[0]


def test_multimodal_refuses_a_text_only_model(artifacts, mm_artifacts):
    model_path, tok_path = artifacts
    with pytest.raises(ValueError, match="doesn't support multimodality"):
        BackendServer(model_path, tok_path, device="cpu", multimodal=True)
    # a multimodal model served without --multimodal drops the image
    mm_model, mm_tok, msg = mm_artifacts
    srv = BackendServer(mm_model, mm_tok, temperature=0.0, max_new_tokens=8,
                        device="cpu")
    conn = Conn([msg])
    (turns, status), = talk(srv, conn)
    assert not status and len(turns) == 1
    assert all(m["category"] != "FEATURE" for m in conn.sent)


def _mm_server(mm_artifacts, **kw):
    model_path, tok_path, _ = mm_artifacts
    return BackendServer(model_path, tok_path, temperature=0.0,
                         max_new_tokens=8, multimodal=True, device="cpu",
                         **kw)


def _mm_talk(srv, msgs):
    """(turns, status) of one conversation with a --multimodal server,
    after its FEATURE line."""
    conn = Conn(msgs)
    try:
        talk(srv, conn)
    finally:
        srv.shutdown()
    assert conn.sent[0] == {"category": "FEATURE", "text": "multimodal"}
    conn.sent = conn.sent[1:]
    return replies(conn)


def _fresh_reply(mm_artifacts, msg, **kw):
    """The reply to `msg` as a conversation's first message."""
    turns, status = _mm_talk(_mm_server(mm_artifacts, **kw), [msg])
    assert not status and len(turns) == 1
    return turns[0]


@pytest.mark.parametrize("batch", [0, 2])
@pytest.mark.parametrize("bad", [
    base64.b64encode(b"these bytes are no image").decode(),
    "not base64!"])
def test_multimodal_unreadable_image(mm_artifacts, batch, bad):
    """An image field that is not base64, or not an image: the unreadable
    status and "<eos>" end the message, the connection stays open, and the
    next message is answered as a conversation's first."""
    msg = json.dumps({"text": "What is in the image?", "image": bad})
    turns, status = _mm_talk(_mm_server(mm_artifacts, batch=batch),
                             [msg, MSGS[1]])
    assert status == [IMAGE_STATUS[0], IMAGE_UNREADABLE]
    assert turns == ["", _fresh_reply(mm_artifacts, MSGS[1], batch=batch)]


def test_multimodal_image_past_the_kv_pool(mm_artifacts):
    """--batch with a paged pool of 192 rows and an image of 320: the
    capacity status and "<eos>" end the message, the slot keeps no row
    and no page of it, and the next message is answered as a
    conversation's first."""
    kw = dict(batch=2, pool_tokens=192, page_size=64)
    srv = _mm_server(mm_artifacts, **kw)
    turns, status = _mm_talk(srv, [mm_artifacts[2], MSGS[1]])
    assert srv.scheduler.sched.pages_used() == 0
    assert status == list(IMAGE_STATUS) + [CAPACITY]
    assert turns == ["", _fresh_reply(mm_artifacts, MSGS[1], **kw)]

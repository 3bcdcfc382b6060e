"""Local chat app: one process serves a chat page over HTTP and the
model over the backend's WebSocket protocol (the port of
`lmrs_tpu/cli/desktop.py`; lm.rs ships a native desktop window, a headless
host takes a local web app).  The page streams OUTPUT pieces until
"<eos>" and renders a little markdown in the browser.  The model is the
port's `serve.backend.BackendServer`, with the flags its command line
has; the `websockets` package is imported only when the app starts
serving.

Usage:
    python -m lmrs_tpu_torch.cli.desktop --model m.lmrs --tokenizer
        tokenizer.bin [--port 8080] [--ws-port 5000] [--temperature 0.7]
        [--top-p 0.9] [--batch N] [--cache-dtype int8] [--device cpu]
Then open http://127.0.0.1:8080 in a browser.
"""

from __future__ import annotations

import argparse
import asyncio
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>lm.rs tpu</title><style>
body{font-family:system-ui,sans-serif;margin:0;background:#111;color:#eee;
     display:flex;flex-direction:column;height:100vh}
#log{flex:1;overflow-y:auto;padding:1rem;max-width:52rem;margin:0 auto;width:100%;box-sizing:border-box}
.msg{margin:.6rem 0;padding:.6rem .9rem;border-radius:.6rem;white-space:pre-wrap;word-wrap:break-word}
.user{background:#2b3a55;margin-left:4rem}
.bot{background:#222;margin-right:4rem}
.status{color:#888;font-style:italic;font-size:.85rem}
#bar{display:flex;gap:.5rem;padding:.8rem;max-width:52rem;margin:0 auto;width:100%;box-sizing:border-box}
#inp{flex:1;padding:.6rem;border-radius:.5rem;border:1px solid #444;background:#1a1a1a;color:#eee}
button{padding:.6rem 1.2rem;border-radius:.5rem;border:none;background:#3a6ea5;color:#fff;cursor:pointer}
code{background:#000;padding:.1rem .3rem;border-radius:.3rem}
pre{background:#000;padding:.6rem;border-radius:.5rem;overflow-x:auto}
b{color:#fff}</style></head><body>
<div id="log"></div>
<div id="bar"><input id="inp" placeholder="Message..." autofocus>
<button id="send">Send</button></div>
<script>
const WS_PORT = __WS_PORT__;
const log = document.getElementById('log');
const inp = document.getElementById('inp');
let ws, current = null, buffer = '';

// minimal markdown: fenced code, inline code, bold, italic, headers
function md(t){
  t = t.replace(/&/g,'&amp;').replace(/</g,'&lt;').replace(/>/g,'&gt;');
  t = t.replace(/```([\\s\\S]*?)```/g, (_,c)=>'<pre>'+c+'</pre>');
  t = t.replace(/`([^`]+)`/g, '<code>$1</code>');
  t = t.replace(/\\*\\*([^*]+)\\*\\*/g, '<b>$1</b>');
  t = t.replace(/(^|\\n)### ([^\\n]+)/g, '$1<b>$2</b>');
  t = t.replace(/(^|\\n)## ([^\\n]+)/g, '$1<b>$2</b>');
  t = t.replace(/(^|\\n)# ([^\\n]+)/g, '$1<b>$2</b>');
  return t;
}
function add(cls, text){
  const d = document.createElement('div');
  d.className = 'msg ' + cls;
  d.innerHTML = md(text);
  log.appendChild(d);
  log.scrollTop = log.scrollHeight;
  return d;
}
function connect(){
  ws = new WebSocket('ws://' + location.hostname + ':' + WS_PORT);
  ws.onmessage = (ev) => {
    const m = JSON.parse(ev.data);
    if (m.category === 'STATUS'){ add('status', m.text); return; }
    if (m.category === 'FEATURE'){ return; }
    if (m.text === '<eos>'){ current = null; buffer=''; return; }
    if (!current) current = add('bot','');
    buffer += m.text;
    current.innerHTML = md(buffer);
    log.scrollTop = log.scrollHeight;
  };
  ws.onclose = () => setTimeout(connect, 1000);
}
connect();
function send(){
  const t = inp.value.trim();
  if(!t || ws.readyState !== 1) return;
  add('user', t);
  ws.send(JSON.stringify({text: t}));
  inp.value = '';
}
document.getElementById('send').onclick = send;
inp.addEventListener('keydown', e => { if(e.key === 'Enter') send(); });
</script></body></html>
"""


class _PageHandler(BaseHTTPRequestHandler):
    """Serves PAGE with the model socket's port filled in."""

    ws_port = 5000

    def do_GET(self):
        body = PAGE.replace("__WS_PORT__", str(self.ws_port)).encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def build_argparser() -> argparse.ArgumentParser:
    """The backend's flags, with --port for the page and --ws-port for
    the model socket."""
    from lmrs_tpu_torch.serve.backend import \
        build_argparser as backend_argparser

    p = argparse.ArgumentParser(description="lmrs_tpu_torch local chat app",
                                parents=[backend_argparser()],
                                conflict_handler="resolve")
    p.add_argument("--port", type=int, default=8080,
                   help="port of the chat page")
    p.add_argument("--ws-port", dest="ws_port", type=int, default=5000,
                   help="port of the model socket")
    return p


def main(argv=None):
    from lmrs_tpu_torch.serve.backend import BackendServer

    args = build_argparser().parse_args(argv)
    server = BackendServer(args.model, args.tokenizer, args.temperature,
                           args.top_p, args.seed, args.multimodal,
                           num_crops=args.num_crops,
                           cache_dtype=args.cache_dtype, batch=args.batch,
                           max_ctx=args.max_ctx, tp=args.tp, cp=args.cp,
                           spec_k=args.spec_k, pool_tokens=args.pool_tokens,
                           page_size=args.page_size, dp=args.dp,
                           no_paged=args.no_paged, device=args.device)
    server.warmup()
    _PageHandler.ws_port = args.ws_port
    httpd = ThreadingHTTPServer((args.ip, args.port), _PageHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"Chat UI on http://{args.ip}:{args.port} "
          f"(model socket ws://{args.ip}:{args.ws_port})")
    try:
        asyncio.run(server.serve(args.ip, args.ws_port))
    except KeyboardInterrupt:
        print("\nShutting down.")
    finally:
        httpd.shutdown()
        server.shutdown()


if __name__ == "__main__":
    main()

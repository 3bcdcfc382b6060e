"""lmrs_tpu_torch.tokenizer against lmrs_tpu.tokenizer on the toy vocab of
tests/test_tokenizer.py, and the port's chat CLI on the CPU.

Tolerance: exact (token ids, strings and bytes).
"""

import json
import os
import subprocess
import sys

import pytest

from lmrs_tpu.config import ModelType as JModelType
from lmrs_tpu.tokenizer import StreamDecoder as JStreamDecoder
from lmrs_tpu.tokenizer import Tokenizer as JTokenizer

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import write_lmrs
from lmrs_tpu_torch.io.synthetic import random_weights, tiny_config
from lmrs_tpu_torch.tokenizer import StreamDecoder, Tokenizer
from test_tokenizer import make_toy_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world", "hello", "wordword hello", "é hello", "w o r l d",
         "héllo wörld ✓"]


def _pair():
    j = make_toy_tokenizer()
    j._native = None                  # the JAX package's pure-Python loop
    t = Tokenizer(j.vocab, j.scores, j.bos, j.eos)
    return j, t


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_match_jax(text):
    j, t = _pair()
    assert t.encode(text) == j.encode(text)
    assert t.encode(text, bos=True, eos=True) == \
        j.encode(text, bos=True, eos=True)
    for fam in ModelType:
        assert t.encode(text, chat_format=True, model_type=fam) == \
            j.encode(text, chat_format=True, model_type=JModelType(int(fam)))
    ids = t.encode(text)
    assert [t.decode(i) for i in ids] == [j.decode(i) for i in ids]
    td, jd = StreamDecoder(t), JStreamDecoder(j)
    assert "".join(td.push(i) for i in ids) + td.flush() == \
        "".join(jd.push(i) for i in ids) + jd.flush()


def test_container_roundtrip_with_jax(tmp_path):
    j, t = _pair()
    t.save(str(tmp_path / "t.bin"))
    j.save(str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    back = Tokenizer.from_file(str(tmp_path / "j.bin"))
    jback = JTokenizer.from_file(str(tmp_path / "t.bin"))
    assert (back.vocab, back.scores, back.bos, back.eos,
            back.max_token_len) == (jback.vocab, jback.scores, jback.bos,
                                    jback.eos, jback.max_token_len)


def test_chat_cli_answers_on_cpu(tmp_path):
    """`python -m lmrs_tpu_torch.cli.chat --device cpu` answers one piped
    prompt on a tiny model and exits 0 at end of input."""
    # Gemma's chat template ids reach 2516
    cfg = tiny_config(ModelType.GEMMA, QuantType.Q4_0, vocab_size=4096)
    write_lmrs(str(tmp_path / "m.lmrs"), cfg, random_weights(cfg, 0))
    j, _ = _pair()
    fill = cfg.vocab_size - len(j.vocab)      # every sampled id decodes
    Tokenizer(j.vocab + [f"<unused{i}>" for i in range(fill)],
              j.scores + [0.0] * fill, j.bos, j.eos).save(
                  str(tmp_path / "tok.bin"))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "lmrs_tpu_torch.cli.chat", "--model",
         str(tmp_path / "m.lmrs"), "--tokenizer", str(tmp_path / "tok.bin"),
         "--device", "cpu", "--temperature", "0", "--max-new-tokens", "8",
         "--show-metrics"],
        input="hello world\n", capture_output=True, text=True, timeout=120,
        env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "Assistant:" in out.stdout and "Speed:" in out.stdout
    # the plain versions ran: no CUDA kernel was launched
    counted = [ln for ln in out.stdout.splitlines()
               if ln.startswith("Kernel launches since start: ")]
    counts = json.loads(counted[-1].split(": ", 1)[1])
    assert set(counts) == {"q4_gemv", "q4_gemm", "flash_attention",
                           "q8_gemv_i8", "q8_gemv", "q8_gemm",
                           "flash_attention_i8", "flash_attention_i4",
                           "flash_attention_batched", "flash_attention_paged",
                           "ffn_fused_xe", "ffn_fused", "flash_merge",
                           "flash_attention_batched_lse"}
    assert not any(counts.values())
    assert "jax" not in out.stderr.lower()
    # --spec-k: the same greedy reply, and the acceptance rate is printed
    base = [sys.executable, "-m", "lmrs_tpu_torch.cli.chat", "--model",
            str(tmp_path / "m.lmrs"), "--tokenizer",
            str(tmp_path / "tok.bin"), "--device", "cpu"]
    spec = subprocess.run(
        base + ["--temperature", "0", "--max-new-tokens", "8",
                "--show-metrics", "--spec-k", "3"],
        input="hello world\n", capture_output=True, text=True, timeout=120,
        env=env, cwd=str(tmp_path))
    assert spec.returncode == 0, spec.stderr

    def reply(text):
        lines = text.splitlines()
        at = [i for i, ln in enumerate(lines) if ln.endswith("Assistant:")]
        return lines[at[0] + 1]

    assert reply(spec.stdout) == reply(out.stdout)
    assert "Speculative: " in spec.stdout and "drafts accepted" in spec.stdout
    # --tp 2 and --cp 2 run the same model on a mesh of two ranks (two
    # processes on the CPU): the greedy reply of the one-device CLI, and
    # the launch counts of both ranks; an indivisible tp raises
    for flags in (["--tp", "2"], ["--cp", "2"]):
        mesh = subprocess.run(
            base + flags + ["--temperature", "0", "--max-new-tokens", "8",
                            "--show-metrics"],
            input="hello world\n", capture_output=True, text=True,
            timeout=120, env=env, cwd=str(tmp_path))
        assert mesh.returncode == 0, mesh.stderr
        assert f"mesh: tp={flags[1] if flags[0] == '--tp' else 1}" \
            in mesh.stdout
        assert reply(mesh.stdout) == reply(out.stdout)
        assert "jax" not in mesh.stderr.lower()
    bad = subprocess.run(base + ["--tp", "3"], input="", capture_output=True,
                         text=True, timeout=120, env=env)
    assert bad.returncode != 0 and "tp=3 incompatible" in bad.stderr


def test_chat_cli_q8_int8_cache_on_cpu(tmp_path):
    """The Q8_0 path with `--cache-dtype int8`, `int4` and `float32`
    through the CLI on the CPU."""
    # Gemma: its chat template ids fit a 4096-entry vocabulary
    cfg = tiny_config(ModelType.GEMMA, QuantType.Q8_0, vocab_size=4096)
    write_lmrs(str(tmp_path / "m.lmrs"), cfg, random_weights(cfg, 0))
    j, _ = _pair()
    fill = cfg.vocab_size - len(j.vocab)
    Tokenizer(j.vocab + [f"<unused{i}>" for i in range(fill)],
              j.scores + [0.0] * fill, j.bos, j.eos).save(
                  str(tmp_path / "tok.bin"))
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "lmrs_tpu_torch.cli.chat", "--model",
            str(tmp_path / "m.lmrs"), "--tokenizer",
            str(tmp_path / "tok.bin"), "--device", "cpu"]
    for w8a8 in ("1", "0"):
        out = subprocess.run(
            base + ["--temperature", "0", "--max-new-tokens", "8",
                    "--cache-dtype", "int8"],
            input="hello world\n", capture_output=True, text=True,
            timeout=120, env=dict(env, LMRS_W8A8=w8a8), cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert "Using Q8_0 quantization." in out.stdout
        lines = out.stdout.splitlines()
        at = [i for i, ln in enumerate(lines) if ln.endswith("Assistant:")]
        assert lines[at[0] + 1].strip()
    for dtype in ("int4", "float32"):
        out = subprocess.run(
            base + ["--temperature", "0", "--max-new-tokens", "8",
                    "--cache-dtype", dtype],
            input="hello world\n", capture_output=True, text=True,
            timeout=120, env=env, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        at = [i for i, ln in enumerate(lines) if ln.endswith("Assistant:")]
        assert lines[at[0] + 1].strip()



def test_chat_cli_image_turn_on_cpu(tmp_path):
    """--image on a tiny Phi-3.5-vision file: the image is encoded and
    prefilled, and the first turn's greedy reply is the Engine's after
    prefill_embeds of the same rows and the image turn's tokens (the text
    without the chat template, then PHI_TURN_SUFFIX).  A text-only model
    refuses --image."""
    from PIL import Image

    from lmrs_tpu_torch.cli.chat import PHI_TURN_SUFFIX
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import (params_from_lmrs,
                                          vision_params_from_lmrs)
    from lmrs_tpu_torch.models.phi3v import encode_image_to_embeds
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
    from test_torch_multimodal import image, write_tiny_mm

    model = write_tiny_mm(str(tmp_path / "mm.lmrs"))
    j, _ = _pair()
    fill = 32064 - len(j.vocab)
    tok = Tokenizer(j.vocab + [f"<unused{i}>" for i in range(fill)],
                    j.scores + [0.0] * fill, j.bos, j.eos)
    tok.save(str(tmp_path / "tok.bin"))
    png = str(tmp_path / "img.png")
    Image.fromarray(image(3, (50, 70, 3))).save(png)
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "lmrs_tpu_torch.cli.chat", "--model",
            model, "--tokenizer", str(tmp_path / "tok.bin"), "--device",
            "cpu", "--temperature", "0", "--max-new-tokens", "6"]
    out = subprocess.run(base + ["--image", png, "--num-crops", "2"],
                         input="hello world\n", capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "Preprocessing the image..." in out.stdout
    lines = out.stdout.splitlines()
    at = [i for i, ln in enumerate(lines) if ln.endswith("Assistant:")]
    f = read_lmrs(model)
    params = params_from_lmrs(f, device="cpu")
    eng = Engine(f.cfg, params, device="cpu")
    eng.prefill_embeds(encode_image_to_embeds(
        vision_params_from_lmrs(f, "cpu"), params, f.cfg, png, 2),
        want_logits=False)
    toks = eng.generate(tok.encode("hello world") + PHI_TURN_SUFFIX,
                        GenerationConfig(temperature=0.0, max_new_tokens=6),
                        stop_tokens={tok.eos})
    dec = StreamDecoder(tok)
    want = "".join(dec.push(t) for t in toks if t != tok.eos) + dec.flush()
    assert lines[at[0] + 1] == want
    # a text-only model: the JAX CLI's message
    cfg = tiny_config(ModelType.GEMMA, QuantType.Q8_0, vocab_size=4096)
    write_lmrs(str(tmp_path / "t.lmrs"), cfg, random_weights(cfg, 0))
    bad = subprocess.run(base[:4] + [str(tmp_path / "t.lmrs")] + base[5:]
                         + ["--image", png], input="", capture_output=True,
                         text=True, timeout=120, env=env)
    assert bad.returncode != 0
    assert "Cannot use images in a non-multimodal model." in bad.stderr

"""The port's tokenizer exporters against the JAX package's (CPU): both
run on a stub `transformers` module whose tokenizers are duck-typed (an
`sp_model`, `added_tokens_decoder`, `decode`), so no model is downloaded.

Tolerance: the `tokenizer.bin` files byte for byte.
"""

import sys
import types

import pytest
import torch

from lmrs_tpu.io.tokenizer_export import export_tokenizer as jax_export

from lmrs_tpu_torch.io.tokenizer_export import EXPORTERS, export_tokenizer
from lmrs_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

N_SP = 300          # SentencePiece pieces of the stub


class StubSentencePiece:
    """An sp_model: pieces with '▁' word marks, byte pieces, some
    non-ASCII text, and scores that are not whole numbers."""

    def __init__(self):
        words = ["▁hello", "▁world", "été", "▁你",
                 "▁▁", "ab▁c"]
        self.pieces = (["<unk>", "<s>", "</s>"]
                       + [f"<0x{b:02X}>" for b in range(256)] + words)
        self.pieces += [f"p{i}" for i in range(N_SP - len(self.pieces))]

    def vocab_size(self):
        return len(self.pieces)

    def id_to_piece(self, i):
        return self.pieces[i]

    def get_score(self, i):
        return -0.37 * i

    def bos_id(self):
        return 1

    def eos_id(self):
        return 2


class Added:
    def __init__(self, content):
        self.content = content


class StubTokenizer:
    def __init__(self, model_id):
        self.model_id = model_id
        self.sp_model = StubSentencePiece()
        self.bos_token_id, self.eos_token_id = 7, 9
        # ids at and below the sp vocabulary are skipped by export_phi
        self.added_tokens_decoder = {
            N_SP + 5: Added("<|end|>"), N_SP - 1: Added("<|skip|>"),
            N_SP + 1: Added("<|user|>"), N_SP + 2: Added("▁<|sys|>")}

    def __len__(self):
        return 280

    def decode(self, ids):
        (i,) = ids
        return self.sp_model.pieces[i].replace("▁", " ")


@pytest.fixture
def stub_transformers(monkeypatch):
    calls = []

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(model_id, use_fast=True):
            calls.append((model_id, use_fast))
            return StubTokenizer(model_id)

    mod = types.ModuleType("transformers")
    mod.AutoTokenizer = AutoTokenizer
    monkeypatch.setitem(sys.modules, "transformers", mod)
    return calls


@pytest.mark.parametrize("kind,model_id", [
    ("GEMMA", "google/gemma-2-9b-it"),
    ("LLAMA", "meta-llama/Llama-3.2-1B-Instruct"),
    ("PHI", "microsoft/Phi-3.5-mini-instruct"),
    ("PHI", "microsoft/Phi-3.5-vision-instruct")])
def test_tokenizer_bin_matches_jax_byte_for_byte(tmp_path, stub_transformers,
                                                 kind, model_id):
    jax_export(model_id, kind, str(tmp_path / "jax.bin"))
    jax_calls = list(stub_transformers)
    stub_transformers.clear()
    tok = export_tokenizer(model_id, kind.lower(), str(tmp_path / "port.bin"))
    assert stub_transformers == jax_calls
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    back = Tokenizer.from_file(str(tmp_path / "port.bin"))
    assert back.vocab == tok.vocab and back.eos == tok.eos
    if kind == "PHI":
        assert tok.eos == 32007
        assert ("<|placeholder7|>" in tok.vocab) == ("mini" in model_id)
        assert [c[0] for c in jax_calls][-1] == \
            "microsoft/Phi-3.5-mini-instruct"
    if kind != "LLAMA":
        assert tok.vocab[1] == "\n<s>\n" and tok.vocab[2] == "\n</s>\n"
        assert " hello" in tok.vocab


def test_an_exporter_without_transformers_raises(monkeypatch):
    """Importing the module needs no `transformers`; calling an exporter
    does."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert set(EXPORTERS) == {"GEMMA", "LLAMA", "PHI"}
    with pytest.raises(ImportError):
        export_tokenizer("google/gemma-2-9b-it", "GEMMA", "unused.bin")

"""Export Hugging Face tokenizers to the `tokenizer.bin` container.

The same vocabularies, scores and special ids as the JAX package's
`lmrs_tpu/io/tokenizer_export.py` (lm.rs's conversion scripts), written
through `Tokenizer.save`, so both write the same bytes.  It needs the
`transformers` package and the model's tokenizer files (downloaded or
local), and imports `transformers` only inside the exporters.  Where they
are missing, build a `lmrs_tpu_torch.tokenizer.Tokenizer` directly.
"""

from __future__ import annotations

from typing import List, Tuple

from lmrs_tpu_torch.tokenizer import Tokenizer


def _sp_tokens(sp_model, bos_id: int, eos_id: int
               ) -> Tuple[List[str], List[float]]:
    """A SentencePiece vocabulary: bos and eos renamed to '\\n<s>\\n' and
    '\\n</s>\\n', '\u2581' replaced by a space."""
    tokens, scores = [], []
    for i in range(sp_model.vocab_size()):
        t = sp_model.id_to_piece(i)
        if i == bos_id:
            t = "\n<s>\n"
        elif i == eos_id:
            t = "\n</s>\n"
        t = t.replace("\u2581", " ")
        tokens.append(t)
        scores.append(float(sp_model.get_score(i)))
    return tokens, scores


def export_gemma(model_id: str) -> Tokenizer:
    from transformers import AutoTokenizer

    sp = AutoTokenizer.from_pretrained(model_id, use_fast=False).sp_model
    tokens, scores = _sp_tokens(sp, sp.bos_id(), sp.eos_id())
    return Tokenizer(tokens, scores, sp.bos_id(), sp.eos_id())


def export_llama(model_id: str) -> Tokenizer:
    """A tiktoken-style vocabulary: every token decoded on its own, all
    scores 1.0 (the merge order then follows the strings)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_id, use_fast=False)
    n = len(tok)
    tokens = [tok.decode([i]) for i in range(n)]
    return Tokenizer(tokens, [1.0] * n, tok.bos_token_id, tok.eos_token_id)


def export_phi(model_id: str) -> Tokenizer:
    """The SentencePiece vocabulary and the added special tokens after it,
    eos forced to 32007 (<|end|>), and a '<|placeholder7|>' pad appended
    for Phi-3.5-mini-instruct."""
    from transformers import AutoTokenizer

    special = AutoTokenizer.from_pretrained(model_id).added_tokens_decoder
    base_id = ("microsoft/Phi-3.5-mini-instruct"
               if "vision" in model_id else model_id)
    sp = AutoTokenizer.from_pretrained(base_id, use_fast=False).sp_model

    n_words = sp.vocab_size()
    eos_id = 32007
    tokens, scores = _sp_tokens(sp, sp.bos_id(), sp.eos_id())
    for i in sorted(special.keys()):
        if i <= n_words:
            continue
        tokens.append(special[i].content.replace("\u2581", " "))
        scores.append(0.0)
        n_words += 1
    if model_id == "microsoft/Phi-3.5-mini-instruct":
        tokens.append("<|placeholder7|>")
        scores.append(0.0)
    return Tokenizer(tokens, scores, sp.bos_id(), eos_id)


EXPORTERS = {"GEMMA": export_gemma, "LLAMA": export_llama, "PHI": export_phi}


def export_tokenizer(model_id: str, tokenizer_type: str,
                     out_path: str = "tokenizer.bin") -> Tokenizer:
    tok = EXPORTERS[tokenizer_type.upper()](model_id)
    tok.save(out_path)
    return tok

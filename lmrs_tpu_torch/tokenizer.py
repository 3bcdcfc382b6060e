"""SentencePiece-style tokenizer with greedy scored merges + chat templates.

The `tokenizer.bin` container: u32 vocab_size, max_token_len, bos, eos;
then per token f32 score, u32 byte length, utf-8 bytes.

Encoding: each character maps to its vocab token if present, else to
per-byte fallback tokens (byte value + 3); then the adjacent pair whose
concatenation is in the vocab with the highest score merges (leftmost wins
ties), until no merge applies.  The merge loop runs in the C++ engine of
`lmrs_tpu_torch.native` (built with g++ at first use) unless the
tokenizer is made with `native=False`; `_merge_plain` is its pure-Python
plain version, with the same results.  Without g++ the tokenizer keeps the
plain loop and warns once.
"""

from __future__ import annotations

import struct
import warnings
from typing import Dict, List, Optional, Sequence

from lmrs_tpu_torch.config import ModelType

# Hardcoded chat-format token ids
CHAT_PREFIX = {
    ModelType.GEMMA: lambda bos: [bos, 106, 1645, 108],
    ModelType.LLAMA: lambda bos: [128006, 882, 128007, 271],
    ModelType.PHI: lambda bos: [bos, 32010, 29871, 13],
}
CHAT_SUFFIX = {
    ModelType.GEMMA: [107, 108, 106, 2516, 108],
    ModelType.LLAMA: [128009, 128006, 78191, 128007, 271],
    ModelType.PHI: [32007, 29871, 13, 32001, 29871, 13],
}
# End-of-turn tokens the front ends suppress and stop on (besides eos):
# Gemma's 107 <end_of_turn>
EXTRA_STOP_TOKENS = {
    ModelType.GEMMA: (107,),
    ModelType.LLAMA: (),
    ModelType.PHI: (),
}


class Tokenizer:
    def __init__(self, vocab: Sequence[str], scores: Sequence[float],
                 bos: int, eos: int, max_token_len: Optional[int] = None,
                 native: bool = True):
        if len(vocab) != len(scores):
            raise ValueError(f"{len(vocab)} tokens but {len(scores)} scores")
        self.vocab: List[str] = list(vocab)
        # float32, as the container stores them and the C++ engine
        # compares them: two scores that round to one float32 tie in both
        # merge loops
        self.scores: List[float] = list(struct.unpack(
            f"<{len(scores)}f", struct.pack(f"<{len(scores)}f", *scores)))
        self.bos = int(bos)
        self.eos = int(eos)
        self.max_token_len = max_token_len or max(
            (len(v.encode("utf-8")) for v in vocab), default=0)
        # text -> lowest id with that text
        self._lookup: Dict[str, int] = {}
        for i, t in enumerate(self.vocab):
            self._lookup.setdefault(t, i)
        self._native = self._attach_native() if native else None

    def _attach_native(self):
        """The C++ merge engine over this tokenizer's container bytes, or
        None (with one warning) where there is no g++ to build it."""
        from lmrs_tpu_torch.native import (CompilerMissing,
                                           NativeTokenizerEngine)

        try:
            return NativeTokenizerEngine(self._serialize())
        except CompilerMissing as e:
            warnings.warn(f"{e}; the tokenizer keeps its pure-Python merge "
                          f"loop", RuntimeWarning, stacklevel=3)
            return None

    # ------------------------------------------------------------------
    # container
    # ------------------------------------------------------------------
    def _serialize(self) -> bytes:
        out = [struct.pack("<IIII", len(self.vocab), self.max_token_len,
                           self.bos, self.eos)]
        for s, t in zip(self.scores, self.vocab):
            b = t.encode("utf-8")
            out.append(struct.pack("<fI", s, len(b)))
            out.append(b)
        return b"".join(out)

    @classmethod
    def from_file(cls, path: str, native: bool = True) -> "Tokenizer":
        with open(path, "rb") as f:
            data = f.read()
        vocab_size, max_len, bos, eos = struct.unpack_from("<IIII", data, 0)
        off = 16
        vocab, scores = [], []
        for _ in range(vocab_size):
            score, slen = struct.unpack_from("<fI", data, off)
            off += 8
            vocab.append(data[off:off + slen].decode("utf-8"))
            off += slen
            scores.append(score)
        return cls(vocab, scores, bos, eos, max_len, native=native)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self._serialize())

    # ------------------------------------------------------------------
    # encode
    # ------------------------------------------------------------------
    def encode(self, text: str, bos: bool = False, eos: bool = False,
               chat_format: bool = False,
               model_type: Optional[ModelType] = None) -> List[int]:
        if not text:
            raise ValueError("Text to encode should not be empty")
        tokens: List[int] = []
        if bos:
            tokens.append(self.bos)
        if chat_format:
            if model_type is None:
                raise ValueError("chat_format needs a model_type")
            tokens.extend(CHAT_PREFIX[model_type](self.bos))

        for ch in text:
            tid = self._lookup.get(ch)
            if tid is not None:
                tokens.append(tid)
            else:
                tokens.extend(b + 3 for b in ch.encode("utf-8"))

        tokens = self._merge(tokens)

        if chat_format:
            tokens.extend(CHAT_SUFFIX[model_type])
        if eos:
            tokens.append(self.eos)
        return tokens

    def _merge(self, tokens: List[int]) -> List[int]:
        """Greedy highest-score merge loop: the C++ engine when attached,
        else its plain version."""
        if self._native is not None:
            return self._native.merge(tokens)
        return self._merge_plain(tokens)

    def _merge_plain(self, tokens: List[int]) -> List[int]:
        """The merge loop in pure Python."""
        vocab, scores, lookup = self.vocab, self.scores, self._lookup
        nv = len(vocab)
        tokens = list(tokens)
        while True:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for idx in range(len(tokens) - 1):
                if tokens[idx] >= nv or tokens[idx + 1] >= nv:
                    continue  # special ids outside the text vocab never merge
                merged = vocab[tokens[idx]] + vocab[tokens[idx + 1]]
                tid = lookup.get(merged)
                if tid is not None and scores[tid] > best_score:
                    best_score = scores[tid]
                    best_id = tid
                    best_idx = idx
            if best_idx == -1:
                return tokens
            tokens[best_idx] = best_id
            del tokens[best_idx + 1]

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def decode_bytes(self, token: int) -> bytes:
        """Raw bytes of a token; `<0xHH>` byte tokens yield their byte."""
        piece = self.vocab[token]
        if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
            try:
                return bytes([int(piece[3:5], 16)])
            except ValueError:
                pass
        return piece.encode("utf-8")

    def decode(self, token: int) -> str:
        """Single-token decode; a byte token maps to the character of the
        same value (latin-1), as lm.rs does."""
        piece = self.vocab[token]
        if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
            try:
                return chr(int(piece[3:5], 16))
            except ValueError:
                pass
        return piece


class StreamDecoder:
    """Incremental UTF-8-correct detokenizer for streaming output: bytes
    accumulate until they form valid UTF-8."""

    def __init__(self, tokenizer: Tokenizer):
        self.tok = tokenizer
        self._pending = b""

    def push(self, token: int) -> str:
        self._pending += self.tok.decode_bytes(token)
        try:
            out = self._pending.decode("utf-8")
            self._pending = b""
            return out
        except UnicodeDecodeError as e:
            if e.start > 0:
                out = self._pending[: e.start].decode("utf-8", errors="replace")
                self._pending = self._pending[e.start:]
                if len(self._pending) > 4:  # not a prefix of any codepoint
                    out += self._pending.decode("utf-8", errors="replace")
                    self._pending = b""
                return out
            if len(self._pending) > 4:
                out = self._pending.decode("utf-8", errors="replace")
                self._pending = b""
                return out
            return ""

    def flush(self) -> str:
        out = self._pending.decode("utf-8", errors="replace")
        self._pending = b""
        return out

"""Minimal byte-level tokenizer for tests and demos.

The engine is tokenizer-agnostic (token-id lists in, token-id lists out).
This byte-level tokenizer keeps the serving path runnable with no model
assets: ids 0..255 are raw bytes, 256 is BOS, 257 is EOS.
"""

from __future__ import annotations


class ByteTokenizer:
    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str, *, bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_id] + ids if bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

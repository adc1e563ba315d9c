"""Tokenizers: this package's copy of ``dlti_tpu/data/tokenizer.py``'s
hermetic ``ByteTokenizer`` and ``IdTokenizer`` and of ``get_tokenizer``.

A name that would need the Hugging Face hub raises: the port has no
``transformers`` dependency and its card machine has no network.
"""

from __future__ import annotations

import zlib
from typing import List, Protocol


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    eos_id: int
    bos_id: int

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer with BOS/EOS/PAD specials, vocab 259:
    id 0 = pad, 1 = bos, 2 = eos, byte b -> b + 3."""

    def __init__(self) -> None:
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        # Specials and ids past the byte range decode to nothing.
        data = bytes(i - 3 for i in ids if 3 <= i < 259)
        return data.decode("utf-8", errors="replace")


class IdTokenizer:
    """Id-passthrough tokenizer: id i renders as ``<i>``; text encodes by
    parsing that form, other words hash (crc32) into the vocab."""

    def __init__(self, vocab_size: int = 32000) -> None:
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = []
        for w in text.split():
            if w.startswith("<") and w.endswith(">") and w[1:-1].isdigit():
                ids.append(int(w[1:-1]) % self.vocab_size)
            else:
                ids.append(3 + (zlib.crc32(w.encode()) % (self.vocab_size - 3)))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)


def get_tokenizer(name: str) -> Tokenizer:
    """"byte" / "id[:vocab]" -> the hermetic tokenizers; anything else
    (a hub name or path) raises."""
    if name == "byte":
        return ByteTokenizer()
    if name == "id" or name.startswith("id:"):
        suffix = name.split(":", 1)[1] if ":" in name else ""
        if suffix and not suffix.isdigit():
            raise ValueError(
                f"bad id-tokenizer spec {name!r}: expected 'id' or "
                f"'id:<vocab_size>' (e.g. 'id:4096')")
        return IdTokenizer(int(suffix) if suffix else 32000)
    raise ValueError(
        f"tokenizer {name!r} would need the Hugging Face hub, which the port "
        f"does not use; pass 'byte' or 'id[:vocab]'")

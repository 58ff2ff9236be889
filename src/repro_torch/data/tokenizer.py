"""Byte-level tokenizer — the port's copy of ``repro/data/tokenizer.py``.

IDs: 0=pad, 1=bos, 2=eos, 3..258 = bytes.
"""
from __future__ import annotations

from typing import List, Sequence

PAD, BOS, EOS = 0, 1, 2
BYTE_OFFSET = 3
VOCAB = 256 + BYTE_OFFSET


def encode(text: str, bos: bool = True, eos: bool = False) -> List[int]:
    ids = [b + BYTE_OFFSET for b in text.encode("utf-8")]
    if bos:
        ids = [BOS] + ids
    if eos:
        ids = ids + [EOS]
    return ids


def decode(ids: Sequence[int]) -> str:
    bs = bytes(i - BYTE_OFFSET for i in ids
               if i >= BYTE_OFFSET and i < VOCAB)
    return bs.decode("utf-8", errors="replace")

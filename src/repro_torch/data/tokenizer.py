"""Minimal byte-level tokenizer (self-contained, offline)."""
from __future__ import annotations

from typing import List

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes + BOS/EOS; vocab 256 + 2 specials."""

    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

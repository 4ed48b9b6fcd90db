"""Symbol table with reserved specials of the port: a copy of
``parakeet_tpu/frontend/vocab.py`` (pure Python).

Equivalent of the reference Vocab (reference: parakeet/frontend/vocab.py:20-
130): an ordered symbol list with optional ``<pad> <unk> <s> </s>``
specials reserved at the front, plus lookup / reverse lookup.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, List, Optional

__all__ = ["Vocab"]


class Vocab:
    def __init__(self, symbols: Iterable[str],
                 padding_symbol: Optional[str] = "<pad>",
                 unk_symbol: Optional[str] = "<unk>",
                 start_symbol: Optional[str] = "<s>",
                 end_symbol: Optional[str] = "</s>"):
        specials = []
        for s in (padding_symbol, unk_symbol, start_symbol, end_symbol):
            if s is not None:
                specials.append(s)
        self.padding_symbol = padding_symbol
        self.unk_symbol = unk_symbol
        self.start_symbol = start_symbol
        self.end_symbol = end_symbol

        self.stoi: "OrderedDict[str, int]" = OrderedDict()
        for s in specials:
            if s not in self.stoi:
                self.stoi[s] = len(self.stoi)
        for s in symbols:
            if s not in self.stoi:
                self.stoi[s] = len(self.stoi)
        self.itos: List[str] = list(self.stoi.keys())

    def __len__(self) -> int:
        return len(self.stoi)

    @property
    def num_specials(self) -> int:
        return sum(1 for s in (self.padding_symbol, self.unk_symbol,
                               self.start_symbol, self.end_symbol)
                   if s is not None)

    @property
    def padding_index(self) -> int:
        return self.stoi[self.padding_symbol]

    @property
    def unk_index(self) -> int:
        return self.stoi[self.unk_symbol]

    @property
    def start_index(self) -> int:
        return self.stoi[self.start_symbol]

    @property
    def end_index(self) -> int:
        return self.stoi[self.end_symbol]

    def lookup(self, symbol: str) -> int:
        if symbol in self.stoi:
            return self.stoi[symbol]
        if self.unk_symbol is not None:
            return self.stoi[self.unk_symbol]
        raise KeyError(symbol)

    def reverse(self, index: int) -> str:
        return self.itos[index]

    def __call__(self, symbols: Iterable[str]) -> List[int]:
        return [self.lookup(s) for s in symbols]

    def __repr__(self):
        return f"Vocab({len(self)} symbols)"

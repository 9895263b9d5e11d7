"""Word-piece tokenizer with UTF-8 byte fallback: the vocabulary scheme of
the repository's trained word-LM checkpoints (wordlm-500m / wordlm-1b).

Ids 0..255 are raw UTF-8 bytes (fallback for out-of-vocab pieces); ids
256.. are the most frequent word pieces of the training corpus
(regex-split words, numbers, whitespace runs, punctuation). A plain LM:
`instruct = False` tells the server to send the raw text, with no [INST]
template.
"""

from __future__ import annotations

import json
import re
from typing import List, Sequence

N_BYTE = 256            # ids 0..255: utf-8 byte fallback
PIECE_RE = re.compile(
    r" ?[A-Za-z_']+| ?[0-9]+|[ \t]*\n[ \t]*|[ \t]+|[^\sA-Za-z0-9_']")


class WordTokenizer:
    """vocab: list of word pieces (vocab.json written by the corpus
    stage); piece i maps to id N_BYTE + i."""

    instruct = False     # plain-LM: no [INST] chat template

    def __init__(self, vocab):
        if isinstance(vocab, str):
            with open(vocab) as f:
                vocab = json.load(f)
        self.words: List[str] = list(vocab)
        self.word_ids = {w: N_BYTE + i for i, w in enumerate(self.words)}

    @property
    def vocab_size(self) -> int:
        return N_BYTE + len(self.words)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for piece in PIECE_RE.findall(text):
            i = self.word_ids.get(piece)
            if i is not None:
                out.append(i)
            else:
                out.extend(piece.encode("utf-8", errors="ignore"))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        frags: List[str] = []
        byte_run: List[int] = []
        for i in ids:
            i = int(i)
            if 0 <= i < N_BYTE:
                byte_run.append(i)
                continue
            if byte_run:
                frags.append(bytes(byte_run).decode("utf-8",
                                                    errors="replace"))
                byte_run = []
            j = i - N_BYTE
            frags.append(self.words[j] if 0 <= j < len(self.words) else "")
        if byte_run:
            frags.append(bytes(byte_run).decode("utf-8", errors="replace"))
        return "".join(frags)

    # Tokenizer-protocol aliases (runtime/tokenizer.py Tokenizer)
    def decode_token(self, i: int) -> str:
        return self.decode([i])

"""SentencePiece-BPE tokenizer (Mistral/Llama family).

  - encode: heap-merged BPE in C++ (native/tokenizer.cc, built at first use)
    with a pure-Python fallback of the same algorithm.
  - decode: byte-fallback runs joined, "▁" markers back to spaces.

Reads a HuggingFace tokenizer.json (vocab + merges). Normalization follows
SentencePiece: "▁" word-boundary markers, byte-fallback <0xXX> tokens for
characters outside the vocab. Host code only: ids are Python ints.
"""

from __future__ import annotations

import ctypes
import heapq
import json
from typing import List

SPIECE = "▁"  # ▁


def _native_lib():
    from effort_tpu_torch.runtime._native_build import native_lib_path
    path = native_lib_path()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.effort_tok_new.restype = ctypes.c_void_p
        lib.effort_tok_free.argtypes = [ctypes.c_void_p]
        lib.effort_tok_add_token.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int32]
        lib.effort_tok_add_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int32]
        lib.effort_tok_encode_pieces.restype = ctypes.c_int
        lib.effort_tok_encode_pieces.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        return lib
    except OSError:
        return None


class Tokenizer:
    def __init__(self, tokenizer_json_path: str, use_native: bool = True):
        with open(tokenizer_json_path) as f:
            data = json.load(f)
        model = data["model"]
        self.vocab: dict = model["vocab"]
        self.id_to_tok = {v: k for k, v in self.vocab.items()}
        merges = model.get("merges", [])
        self.merge_rank = {}
        for rank, m in enumerate(merges):
            pair = tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            self.merge_rank[pair] = rank
        self.bos_id = self.vocab.get("<s>", 1)
        self.eos_id = self.vocab.get("</s>", 2)
        self.unk_id = self.vocab.get("<unk>", 0)

        self._lib = _native_lib() if use_native else None
        self._h = None
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.effort_tok_new())
            for tok, i in self.vocab.items():
                b = tok.encode()
                self._lib.effort_tok_add_token(self._h, b, len(b), i)
            for (l, r), rank in self.merge_rank.items():
                lb, rb = l.encode(), r.encode()
                self._lib.effort_tok_add_merge(self._h, lb, len(lb), rb,
                                               len(rb), rank)

    # ---------------- encode ----------------

    @property
    def native(self) -> bool:
        """True when encode runs the C++ merge loop, False on the Python
        fallback."""
        return self._h is not None

    def encode(self, text: str, bos: bool = True) -> List[int]:
        """SentencePiece-style: leading space marker, BPE merge,
        byte-fallback."""
        if not text:
            return [self.bos_id] if bos else []
        text = SPIECE + text.replace(" ", SPIECE)
        pieces = list(text)
        if self._h is not None:
            ids = self._encode_native(pieces)
        else:
            ids = self._encode_py(pieces)
        return ([self.bos_id] if bos else []) + ids

    def _byte_fallback(self, piece: str) -> List[int]:
        out = []
        for byte in piece.encode():
            tok = f"<0x{byte:02X}>"
            out.append(self.vocab.get(tok, self.unk_id))
        return out

    def _encode_native(self, pieces: List[str]) -> List[int]:
        lib, h = self._lib, self._h
        blob = b"".join(p.encode() for p in pieces)
        lens = (ctypes.c_int * len(pieces))(
            *[len(p.encode()) for p in pieces])
        n = len(pieces)
        out_ids = (ctypes.c_int32 * n)()
        out_starts = (ctypes.c_int32 * n)()
        out_lens = (ctypes.c_int32 * n)()
        m = lib.effort_tok_encode_pieces(h, blob, lens, n, out_ids,
                                         out_starts, out_lens)
        ids: List[int] = []
        for i in range(m):
            if out_ids[i] >= 0:
                ids.append(out_ids[i])
            else:
                frag = blob[out_starts[i]:out_starts[i] + out_lens[i]]
                ids.extend(self._byte_fallback(frag.decode(errors="ignore"))
                           or [self.unk_id])
        return ids

    def _encode_py(self, pieces: List[str]) -> List[int]:
        """Pure-Python BPE with the same heap-merge algorithm."""
        nxt = list(range(1, len(pieces))) + [-1]
        prv = [-1] + list(range(len(pieces) - 1))
        alive = [True] * len(pieces)
        heap: list = []
        stamp = 0

        def push(i):
            nonlocal stamp
            if i < 0 or nxt[i] < 0:
                return
            r = self.merge_rank.get((pieces[i], pieces[nxt[i]]))
            if r is not None:
                heapq.heappush(heap, (r, i, stamp))
                stamp += 1

        for i in range(len(pieces) - 1):
            push(i)
        while heap:
            r, i, _ = heapq.heappop(heap)
            if not alive[i] or nxt[i] < 0 or not alive[nxt[i]]:
                continue
            j = nxt[i]
            if self.merge_rank.get((pieces[i], pieces[j])) != r:
                continue
            pieces[i] = pieces[i] + pieces[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] >= 0:
                prv[nxt[i]] = i
            push(prv[i])
            push(i)

        ids: List[int] = []
        i = 0
        while i >= 0:
            if alive[i]:
                tid = self.vocab.get(pieces[i])
                if tid is not None:
                    ids.append(tid)
                else:
                    ids.extend(self._byte_fallback(pieces[i]))
            i = nxt[i]
        return ids

    # ---------------- decode ----------------

    def decode(self, ids: List[int]) -> str:
        parts: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                parts.append(bytes(byte_buf).decode(errors="replace"))
                byte_buf.clear()

        for i in ids:
            tok = self.id_to_tok.get(int(i), "")
            if tok.startswith("<0x") and tok.endswith(">") and len(tok) == 6:
                byte_buf.append(int(tok[3:5], 16))
                continue
            flush()
            if tok in ("<s>", "</s>", "<unk>", "<pad>"):
                continue
            parts.append(tok.replace(SPIECE, " "))
        flush()
        text = "".join(parts)
        return text[1:] if text.startswith(" ") else text

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.effort_tok_free(self._h)
            self._h = None


def mistral_instruct_prompt(query: str) -> str:
    """The [INST] wrapper of Mistral's instruct checkpoints."""
    return f"[INST]{query}[/INST]"

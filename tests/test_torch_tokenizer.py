"""The port's tokenizers held against the JAX package's: the SentencePiece
BPE Tokenizer on a small tokenizer.json that this file writes (byte
fallback tokens, the ASCII characters of a corpus, and merges learned from
it), encode and decode on tests/test_tokenizer.py's SAMPLES through the
native and the Python paths; the word-piece WordTokenizer; the instruct
template. Token ids must be equal, text identical."""

import json
from collections import Counter

import pytest

from effort_tpu.runtime import tokenizer as jax_tokenizer
from effort_tpu.runtime.word_tokenizer import WordTokenizer as JaxWord
from effort_tpu_torch.runtime import tokenizer as port_tokenizer
from effort_tpu_torch.runtime._native_build import NATIVE_DIR, native_lib_path
from effort_tpu_torch.runtime.word_tokenizer import (N_BYTE, PIECE_RE,
                                                     WordTokenizer)
from test_tokenizer import SAMPLES

SPIECE = "▁"
CORPUS = SAMPLES + [
    "the quick brown fox jumps over the lazy dog",
    "hello there, how are you doing today? tell me a story",
    "numbers and separators: 3.14, 2718 and [INST] tags [/INST]",
]


def write_bpe_json(path, n_merges: int = 80, vocab_size: int = 0) -> dict:
    """A SentencePiece-style BPE tokenizer.json: <unk>, <s>, </s>, the 256
    byte-fallback tokens, every ASCII character of CORPUS and "▁", then
    n_merges merges learned greedily from CORPUS's words (the most frequent
    pair first, ties by the pair); with vocab_size, padded to that many
    tokens by word pieces "▁x<i>" (so every id of a model decodes to
    text). Returns its model dict."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    words = [SPIECE + w for text in CORPUS for w in text.split(" ") if w]
    for c in sorted({c for w in words for c in w if c.isascii()}
                    | {SPIECE}):
        vocab.setdefault(c, len(vocab))
    seqs = [list(w) for w in words]
    merges = []
    for _ in range(n_merges):
        pairs = Counter((a, b) for s in seqs for a, b in zip(s, s[1:])
                        if a in vocab and b in vocab)
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        vocab[a + b] = len(vocab)
        for s in seqs:
            i = 0
            while i < len(s) - 1:
                if (s[i], s[i + 1]) == (a, b):
                    s[i:i + 2] = [a + b]
                i += 1
    while len(vocab) < vocab_size:
        vocab[f"{SPIECE}x{len(vocab)}"] = len(vocab)
    model = {"type": "BPE", "vocab": vocab, "merges": merges,
             "byte_fallback": True}
    with open(path, "w") as f:
        json.dump({"version": "1.0", "model": model}, f)
    return model


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    write_bpe_json(p)
    return str(p)


def test_native_lib_builds_in_the_port(tok_path):
    """The C++ helper builds into the port's own native/ directory (never
    under effort_tpu/), and the native encoder is taken when it loads."""
    path = native_lib_path()
    assert path is not None and path.startswith(NATIVE_DIR), path
    assert port_tokenizer.Tokenizer(tok_path).native
    assert not port_tokenizer.Tokenizer(tok_path, use_native=False).native


@pytest.mark.parametrize("native", [True, False])
def test_encode_decode_match_jax(tok_path, native):
    """Every sample, with and without BOS: the port's ids equal JAX's (its
    Python path, which needs no library of the JAX package's build), and
    decode gives JAX's text for the ids and for a run with specials."""
    jt = jax_tokenizer.Tokenizer(tok_path, use_native=False)
    tt = port_tokenizer.Tokenizer(tok_path, use_native=native)
    assert tt.native == native
    assert (tt.bos_id, tt.eos_id, tt.unk_id) == (jt.bos_id, jt.eos_id,
                                                 jt.unk_id)
    merged = 0
    for text in SAMPLES:
        for bos in (True, False):
            ids = tt.encode(text, bos=bos)
            assert ids == jt.encode(text, bos=bos), (text, bos)
        merged += len(ids) < len(text.encode()) + 1
        assert tt.decode(ids) == jt.decode(ids), text
    assert merged >= 4, "the merges shortened too few samples"
    ids = [1] + tt.encode("emoji 🙂 test", bos=False) + [2, 0]
    assert tt.decode(ids) == jt.decode(ids) == "emoji 🙂 test"


def test_native_and_python_paths_agree(tok_path):
    """The C++ merge loop and the Python one give the same ids on every
    sample and on a longer text."""
    tn = port_tokenizer.Tokenizer(tok_path)
    tp = port_tokenizer.Tokenizer(tok_path, use_native=False)
    long = " ".join(CORPUS) * 3
    for text in SAMPLES + [long]:
        assert tn.encode(text) == tp.encode(text), text


def test_instruct_prompt_matches_jax():
    q = "Tell me a story."
    assert (port_tokenizer.mistral_instruct_prompt(q)
            == jax_tokenizer.mistral_instruct_prompt(q))


def test_word_tokenizer_matches_jax(tmp_path):
    """WordTokenizer from a list and from a vocab.json: the same ids as
    JAX's, unknown pieces as UTF-8 bytes, decode round-trips the text,
    and the plain-LM flag the server reads."""
    words = ["the", " the", " quick", " brown", "\n", " ", ".", " fox"]
    p = tmp_path / "vocab.json"
    p.write_text(json.dumps(words))
    assert PIECE_RE.pattern == __import__(
        "effort_tpu.runtime.word_tokenizer",
        fromlist=["PIECE_RE"]).PIECE_RE.pattern
    for vocab in (words, str(p)):
        tw, jw = WordTokenizer(vocab), JaxWord(vocab)
        assert tw.vocab_size == jw.vocab_size == N_BYTE + len(words)
        for text in ("the quick brown fox.\n", "Zażółć the fox 🙂", ""):
            ids = tw.encode(text)
            assert ids == jw.encode(text), text
            assert tw.decode(ids) == jw.decode(ids) == text
        assert tw.decode_token(N_BYTE + 2) == " quick"
    assert WordTokenizer.instruct is False

// SentencePiece-style BPE encoder (effort-tpu's PyTorch port; the same
// source and C ABI as the JAX package's effort_tpu/native/).
//
// The hot encode loop lives in C++: a heap-driven merge over a linked list,
// an implementation of standard SentencePiece BPE:
//   - text is pre-normalized by the Python wrapper ("▁" word markers),
//   - greedy lowest-rank pair merging via a min-heap over list nodes,
//   - byte-fallback for characters absent from the vocab is handled by the
//     wrapper (<0xXX> tokens).
//
// Vocabulary and merges are fed in via the C ABI (Python parses
// tokenizer.json; C++ owns the hash maps + merge loop).

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tok {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::string, int32_t> merge_rank;  // "left\x01right"
};

struct Node {
  std::string piece;
  int prev, next;
  bool alive;
};

struct Cand {
  int32_t rank;
  int pos;      // node index of left element
  uint64_t stamp;  // tie-break: earlier insert wins (stable)
  bool operator>(const Cand& o) const {
    if (rank != o.rank) return rank > o.rank;
    if (pos != o.pos) return pos > o.pos;
    return stamp > o.stamp;
  }
};

std::string merge_key(const std::string& a, const std::string& b) {
  std::string k;
  k.reserve(a.size() + b.size() + 1);
  k += a;
  k += '\x01';
  k += b;
  return k;
}

}  // namespace

extern "C" {

void* effort_tok_new() { return new Tok(); }

void effort_tok_free(void* h) { delete static_cast<Tok*>(h); }

void effort_tok_add_token(void* h, const char* bytes, int len, int32_t id) {
  static_cast<Tok*>(h)->vocab.emplace(std::string(bytes, len), id);
}

void effort_tok_add_merge(void* h, const char* l, int ll, const char* r,
                          int rl, int32_t rank) {
  auto* t = static_cast<Tok*>(h);
  t->merge_rank.emplace(merge_key(std::string(l, ll), std::string(r, rl)),
                        rank);
}

int32_t effort_tok_lookup(void* h, const char* bytes, int len) {
  auto* t = static_cast<Tok*>(h);
  auto it = t->vocab.find(std::string(bytes, len));
  return it == t->vocab.end() ? -1 : it->second;
}

// pieces: concatenated initial pieces; piece_lens[n_pieces] byte lengths.
// out_ids/out_starts/out_lens must hold >= n_pieces entries. Returns the
// number of surviving (merged) pieces; pieces without a vocab entry get
// id -1 plus their byte range, and the wrapper applies byte fallback.
int effort_tok_encode_pieces(void* h, const char* pieces,
                             const int* piece_lens, int n_pieces,
                             int32_t* out_ids, int32_t* out_starts,
                             int32_t* out_lens) {
  auto* t = static_cast<Tok*>(h);
  std::vector<Node> nodes;
  std::vector<int> starts(n_pieces);
  nodes.reserve(n_pieces);
  const char* p = pieces;
  int off = 0;
  for (int i = 0; i < n_pieces; ++i) {
    starts[i] = off;
    nodes.push_back(Node{std::string(p, piece_lens[i]), i - 1,
                         i + 1 < n_pieces ? i + 1 : -1, true});
    p += piece_lens[i];
    off += piece_lens[i];
  }

  std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> heap;
  uint64_t stamp = 0;
  auto push_pair = [&](int i) {
    if (i < 0 || nodes[i].next < 0) return;
    auto it = t->merge_rank.find(
        merge_key(nodes[i].piece, nodes[nodes[i].next].piece));
    if (it != t->merge_rank.end())
      heap.push(Cand{it->second, i, stamp++});
  };
  for (int i = 0; i + 1 < n_pieces; ++i) push_pair(i);

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    int i = c.pos;
    if (!nodes[i].alive || nodes[i].next < 0) continue;
    int j = nodes[i].next;
    if (!nodes[j].alive) continue;
    // revalidate: the pair may have changed since queued
    auto it = t->merge_rank.find(merge_key(nodes[i].piece, nodes[j].piece));
    if (it == t->merge_rank.end() || it->second != c.rank) continue;
    // merge j into i
    nodes[i].piece += nodes[j].piece;
    nodes[j].alive = false;
    nodes[i].next = nodes[j].next;
    if (nodes[i].next >= 0) nodes[nodes[i].next].prev = i;
    push_pair(nodes[i].prev);
    push_pair(i);
  }

  int n = 0;
  for (int i = 0; i >= 0 && i < (int)nodes.size(); i = nodes[i].next) {
    if (!nodes[i].alive) continue;
    auto it = t->vocab.find(nodes[i].piece);
    out_ids[n] = it == t->vocab.end() ? -1 : it->second;
    out_starts[n] = starts[i];
    out_lens[n] = (int)nodes[i].piece.size();
    ++n;
  }
  return n;
}

}  // extern "C"

// Native paged KV block manager: radix-tree prefix reuse over full
// blocks, ref-counted sharing, eviction of reusable leaves by
// (priority, LRU).
//
// Copy of the JAX package's cpp/block_manager.cpp for the port's
// runtime/native_block_manager.py (``TLLM_TPU_NATIVE=1``), whose ctypes
// bindings build it with g++ at first use into tensorrt_llm_tpu_torch/
// _build/; the Python manager (runtime/kv_cache_manager.py) stays the
// behavioural reference.

#include <cstdint>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <unordered_map>
#include <vector>

namespace {

using i64 = long long;

struct KeyHash {
    size_t operator()(const std::vector<int32_t>& v) const {
        size_t h = 1469598103934665603ull;
        for (int32_t x : v) {
            h ^= static_cast<size_t>(x) + 0x9e3779b97f4a7c15ull;
            h *= 1099511628211ull;
        }
        return h;
    }
};

struct Block {
    int32_t id = -1;
    int32_t ref_count = 0;
    int32_t priority = 35;
    bool in_tree = false;
    uint64_t lru_tick = 0;
    Block* parent = nullptr;
    std::vector<int32_t> key;  // tokens (+salt folded into last element slot)
    std::unordered_map<std::vector<int32_t>, Block*, KeyHash> children;
};

struct Manager {
    int32_t num_blocks;
    int32_t tokens_per_block;
    bool enable_reuse;
    std::vector<Block> blocks;
    std::vector<int32_t> free_list;
    // reusable: priority -> (lru ordered ids)
    std::map<int32_t, std::list<int32_t>> reusable;
    std::unordered_map<int32_t, std::list<int32_t>::iterator> reusable_pos;
    size_t num_reusable = 0;
    Block root;
    uint64_t clock = 0;
    std::unordered_map<i64, std::vector<int32_t>> seq_blocks;
    // stats
    i64 reused_blocks = 0, missed_blocks = 0;

    explicit Manager(int32_t n, int32_t tpb, bool reuse)
        : num_blocks(n), tokens_per_block(tpb), enable_reuse(reuse),
          blocks(n) {
        for (int32_t i = 0; i < n; ++i) blocks[i].id = i;
        for (int32_t i = n - 1; i >= 0; --i) free_list.push_back(i);
        root.in_tree = true;
    }

    int32_t blocks_for(i64 tokens) const {
        return static_cast<int32_t>((tokens + tokens_per_block - 1) /
                                    tokens_per_block);
    }

    void reusable_add(Block& b) {
        b.lru_tick = ++clock;
        auto& lst = reusable[b.priority];
        lst.push_back(b.id);
        reusable_pos[b.id] = std::prev(lst.end());
        ++num_reusable;
    }

    void reusable_remove(Block& b) {
        auto it = reusable_pos.find(b.id);
        if (it == reusable_pos.end()) return;
        auto& lst = reusable[b.priority];
        lst.erase(it->second);
        if (lst.empty()) reusable.erase(b.priority);
        reusable_pos.erase(it);
        --num_reusable;
    }

    void release(Block& b) {
        if (--b.ref_count == 0) {
            if (b.in_tree) reusable_add(b);
            else free_list.push_back(b.id);
        }
    }

    Block* evict_one() {
        for (auto& [prio, lst] : reusable) {
            for (int32_t id : lst) {
                Block& b = blocks[id];
                if (b.children.empty()) {
                    reusable_remove(b);
                    if (b.parent) b.parent->children.erase(b.key);
                    b.parent = nullptr;
                    b.in_tree = false;
                    b.key.clear();
                    return &b;
                }
            }
        }
        return nullptr;
    }

    Block* allocate() {
        Block* b;
        if (!free_list.empty()) {
            b = &blocks[free_list.back()];
            free_list.pop_back();
        } else {
            b = evict_one();
            if (!b) return nullptr;
        }
        b->ref_count = 1;
        b->priority = 35;
        return b;
    }

    i64 free_count() const {
        return static_cast<i64>(free_list.size()) +
               static_cast<i64>(num_reusable);
    }
};

std::vector<int32_t> make_key(const int32_t* tokens, int32_t n,
                              int32_t salt) {
    std::vector<int32_t> k(tokens, tokens + n);
    k.push_back(salt);  // cache-salt / lora-id discriminator
    return k;
}

}  // namespace

extern "C" {

void* bm_create(int32_t num_blocks, int32_t tokens_per_block,
                int32_t enable_reuse) {
    return new Manager(num_blocks, tokens_per_block, enable_reuse != 0);
}

void bm_destroy(void* h) { delete static_cast<Manager*>(h); }

i64 bm_free_blocks(void* h) { return static_cast<Manager*>(h)->free_count(); }

// Claims blocks for a new sequence. Returns reused token count, or -1 on
// out-of-blocks. out_blocks must have room for blocks_for(n_prompt).
i64 bm_add_sequence(void* h, i64 seq_id, const int32_t* prompt,
                    int32_t n_prompt, int32_t salt, int32_t enable_reuse,
                    int32_t* out_blocks) {
    Manager& m = *static_cast<Manager*>(h);
    if (m.seq_blocks.count(seq_id)) return -2;
    std::vector<int32_t> chain;
    i64 reused_tokens = 0;
    bool reuse = m.enable_reuse && enable_reuse != 0;
    Block* node = &m.root;
    if (reuse) {
        int32_t matchable = n_prompt - 1;
        int32_t pos = 0;
        while (matchable - pos >= m.tokens_per_block) {
            auto key = make_key(prompt + pos, m.tokens_per_block, salt);
            auto it = node->children.find(key);
            if (it == node->children.end()) break;
            Block* child = it->second;
            if (child->ref_count == 0) m.reusable_remove(*child);
            child->ref_count++;
            chain.push_back(child->id);
            pos += m.tokens_per_block;
            node = child;
        }
        reused_tokens = pos;
    }
    int32_t total_needed = m.blocks_for(n_prompt);
    int32_t new_needed = total_needed - static_cast<int32_t>(chain.size());
    if (new_needed > m.free_count()) {
        for (int32_t id : chain) m.release(m.blocks[id]);
        return -1;
    }
    m.reused_blocks += chain.size();
    m.missed_blocks += new_needed;
    for (int32_t i = 0; i < new_needed; ++i) {
        Block* b = m.allocate();
        if (!b) {  // shouldn't happen given the check above
            for (int32_t id : chain) m.release(m.blocks[id]);
            return -1;
        }
        chain.push_back(b->id);
    }
    std::memcpy(out_blocks, chain.data(), chain.size() * sizeof(int32_t));
    m.seq_blocks[seq_id] = std::move(chain);
    return reused_tokens;
}

// Ensures capacity through `total_tokens`; appends new block ids to
// out_blocks (caller sizes it at blocks_for(total_tokens)). Returns the
// new chain length or -1 on out-of-blocks.
i64 bm_grow(void* h, i64 seq_id, i64 total_tokens, int32_t* out_blocks) {
    Manager& m = *static_cast<Manager*>(h);
    auto it = m.seq_blocks.find(seq_id);
    if (it == m.seq_blocks.end()) return -2;
    auto& chain = it->second;
    int32_t needed = m.blocks_for(total_tokens);
    while (static_cast<int32_t>(chain.size()) < needed) {
        Block* b = m.allocate();
        if (!b) return -1;
        chain.push_back(b->id);
    }
    std::memcpy(out_blocks, chain.data(), chain.size() * sizeof(int32_t));
    return static_cast<i64>(chain.size());
}

// Shrink to blocks_for(total_tokens) (speculative rewind).
i64 bm_rewind(void* h, i64 seq_id, i64 total_tokens) {
    Manager& m = *static_cast<Manager*>(h);
    auto it = m.seq_blocks.find(seq_id);
    if (it == m.seq_blocks.end()) return -2;
    auto& chain = it->second;
    int32_t needed = m.blocks_for(total_tokens < 1 ? 1 : total_tokens);
    while (static_cast<int32_t>(chain.size()) > needed) {
        m.release(m.blocks[chain.back()]);
        chain.pop_back();
    }
    return static_cast<i64>(chain.size());
}

// Free a sequence; optionally attach full blocks to the reuse tree keyed
// by `tokens` (prompt+outputs).
i64 bm_free_sequence(void* h, i64 seq_id, const int32_t* tokens,
                     int32_t n_tokens, int32_t salt, int32_t store) {
    Manager& m = *static_cast<Manager*>(h);
    auto it = m.seq_blocks.find(seq_id);
    if (it == m.seq_blocks.end()) return -2;
    std::vector<int32_t> chain = std::move(it->second);
    m.seq_blocks.erase(it);
    Block* node = &m.root;
    bool can_store = store != 0 && m.enable_reuse;
    for (size_t i = 0; i < chain.size(); ++i) {
        Block& b = m.blocks[chain[i]];
        int32_t start = static_cast<int32_t>(i) * m.tokens_per_block;
        bool full = start + m.tokens_per_block <= n_tokens;
        if (can_store && full && node != nullptr && !b.in_tree) {
            auto key = make_key(tokens + start, m.tokens_per_block, salt);
            auto existing = node->children.find(key);
            if (existing != node->children.end() &&
                existing->second != &b) {
                m.release(b);
                node = existing->second;
                continue;
            }
            b.key = key;
            b.parent = node;
            b.in_tree = true;
            node->children[key] = &b;
            node = &b;
            m.release(b);
        } else if (b.in_tree) {
            node = &b;
            m.release(b);
        } else {
            node = nullptr;
            m.release(b);
        }
    }
    return 0;
}

i64 bm_set_priority(void* h, i64 seq_id, int32_t priority) {
    Manager& m = *static_cast<Manager*>(h);
    auto it = m.seq_blocks.find(seq_id);
    if (it == m.seq_blocks.end()) return -2;
    for (int32_t id : it->second) m.blocks[id].priority = priority;
    return 0;
}

i64 bm_num_seq_blocks(void* h, i64 seq_id) {
    Manager& m = *static_cast<Manager*>(h);
    auto it = m.seq_blocks.find(seq_id);
    if (it == m.seq_blocks.end()) return 0;
    return static_cast<i64>(it->second.size());
}

i64 bm_stats(void* h, i64* reused, i64* missed, i64* reusable) {
    Manager& m = *static_cast<Manager*>(h);
    *reused = m.reused_blocks;
    *missed = m.missed_blocks;
    *reusable = static_cast<i64>(m.num_reusable);
    return 0;
}

}  // extern "C"

// Linearizability checker for single-register histories (Wing & Gong DFS
// with memoization on (remaining-set, register-value) — the Lowe
// just-in-time optimization shape). Host-side native component: checking is
// sequential search, the one part of the fuzz pipeline that does not
// vectorize onto the card, so it runs as C++ over histories extracted from
// device state. The port's own copy of the JAX package's
// native/linearize.cpp, line for line the same algorithm.
//
// Contract (see madsim_tpu_torch/native.py):
//   op[i]  : 1 = PUT, 2 = GET
//   val[i] : value written (PUT) or value observed (GET)
//   inv[i] : invocation time
//   resp[i]: response time, or < 0 for an operation with no response
//            (crashed/timed-out client) — such an op may have taken effect
//            at any point after inv, or never.
// Returns 1 if the history is linearizable w.r.t. a register initialized
// to 0, else 0. n must be <= 57 (memo packs the set and a value index into
// one 64-bit key); above that it returns -1 and the caller decides.

#include <cstddef>
#include <cstdint>
#include <unordered_set>
#include <vector>

namespace {

struct Ctx {
    int n;
    const int32_t* op;
    const int32_t* val;
    const int64_t* inv;
    const int64_t* resp;
    std::vector<int> validx;          // value -> dense index (per op's val)
    std::unordered_set<uint64_t> seen;
};

bool dfs(Ctx& c, uint64_t mask, int32_t value, int value_idx) {
    if (mask == 0) return true;
    uint64_t key = (mask << 7) | (uint64_t)(value_idx & 0x7f);
    if (!c.seen.insert(key).second) return false;

    // minimal ops: no *completed* remaining op responded before their
    // invocation
    int64_t minresp = INT64_MAX;
    for (int i = 0; i < c.n; i++)
        if ((mask >> i) & 1)
            if (c.resp[i] >= 0 && c.resp[i] < minresp) minresp = c.resp[i];

    for (int i = 0; i < c.n; i++) {
        if (!((mask >> i) & 1)) continue;
        if (c.inv[i] > minresp) continue;  // some op finished before i began
        uint64_t rest = mask & ~(1ull << i);
        if (c.op[i] == 1) {  // PUT: takes effect
            if (dfs(c, rest, c.val[i], c.validx[i])) return true;
        } else {             // GET: must observe the current value
            if (c.val[i] == value && dfs(c, rest, value, value_idx))
                return true;
        }
        if (c.resp[i] < 0) {  // pending op may also never take effect
            if (dfs(c, rest, value, value_idx)) return true;
        }
    }
    return false;
}

}  // namespace

extern "C" int lin_check_register(int n, const int32_t* op,
                                  const int32_t* val, const int64_t* inv,
                                  const int64_t* resp) {
    if (n <= 0) return 1;
    if (n > 57) return -1;  // caller must split
    Ctx c{n, op, val, inv, resp, {}, {}};
    // dense value indices for the memo key (initial value 0 gets index 0)
    c.validx.resize(n);
    std::vector<int32_t> vals{0};
    for (int i = 0; i < n; i++) {
        int idx = -1;
        for (std::size_t j = 0; j < vals.size(); j++)
            if (vals[j] == val[i]) { idx = (int)j; break; }
        if (idx < 0) { idx = (int)vals.size(); vals.push_back(val[i]); }
        c.validx[i] = idx;
    }
    return dfs(c, (n == 64 ? ~0ull : ((1ull << n) - 1)), 0, 0) ? 1 : 0;
}

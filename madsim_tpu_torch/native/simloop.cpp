// Native single-seed discrete-event baseline — the honest denominator.
//
// The port's own copy of the JAX package's native/simloop.cpp. It stands
// in for the reference's per-seed execution model (madsim/src/sim/
// task.rs:110-124: pop task from a heap-ordered queue, poll it, advance
// virtual time) without any per-step dispatch overhead: the SAME flagship
// workload the batched engine runs (5-node Raft under rolling
// kill/restart + partition/heal + 5% packet loss, 1-10ms link latency,
// 24 proposals per leader stint — workloads.flagship_runtime),
// implemented the way the reference would run it — one seed, sequential
// handlers, a binary heap of (deadline, random-priority) events (the
// random tie-break mirrors madsim's random-pop queue, mpsc.rs:75), RNG
// draws per send for loss + latency.
//
// Deliberately NOT included: the per-event global invariant and the
// schedule hash. The reference model has neither (its supervisor can
// only observe at its own wakeups), so charging the native loop for
// them would understate the baseline.
//
// Exported (ctypes, see madsim_tpu_torch/native.py):
//   simloop_run(seed, max_events, out[4])
//     out = {events_dispatched, wall_ns, max_commit_seen, elections}

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr int NN = 5;          // cluster size (bench flagship)
constexpr int L = 32;          // log capacity
constexpr int PW = 8;          // payload words
constexpr int N_CMDS = 24;     // proposals per leader stint
constexpr int MAJ = NN / 2 + 1;

// virtual time: microsecond ticks (core/types.py TICKS_PER_SEC = 1e6)
constexpr int64_t MS = 1000;
constexpr int64_t SEC = 1000 * MS;
constexpr int64_t E_MIN = 150 * MS, E_MAX = 300 * MS;  // election timeout
constexpr int64_t HB = 50 * MS;                        // heartbeat
constexpr int64_t PROP = 100 * MS;                     // propose tick
constexpr int64_t LAT_LO = 1 * MS, LAT_HI = 10 * MS;   // link latency
constexpr double LOSS = 0.05;

enum Kind : uint8_t { MSG, TIMER, SUPER };
enum MTag : int32_t { RV = 1, RVR, AE, AER };
enum TTag : int32_t { T_ELECTION = 1, T_HEARTBEAT, T_PROPOSE };
enum STag : int32_t { KILL_RANDOM = 1, RESTART_RANDOM, PARTITION, HEAL };
enum Role : int32_t { FOLLOWER, CANDIDATE, LEADER };

struct Rng {  // splitmix64
  uint64_t s;
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  int64_t range(int64_t lo, int64_t hi) {  // inclusive
    return lo + (int64_t)(next() % (uint64_t)(hi - lo + 1));
  }
  bool bernoulli(double p) { return (next() >> 11) * 0x1.0p-53 < p; }
};

struct Ev {
  int64_t deadline;
  uint32_t pri;     // random: uniform tie-break among equal deadlines
  Kind kind;
  int32_t node, src, tag;
  int32_t gen;      // dst boot generation at insert (kill clears queue)
  int32_t payload[PW];
};
struct EvCmp {  // min-heap on (deadline, pri)
  bool operator()(const Ev& a, const Ev& b) const {
    return a.deadline != b.deadline ? a.deadline > b.deadline
                                    : a.pri > b.pri;
  }
};

struct Node {
  // persistent (stable storage — survives kill/restart)
  int32_t term = 0, voted_for = -1, log_len = 0;
  int32_t log_term[L] = {}, log_cmd[L] = {};
  // volatile
  int32_t role = FOLLOWER, votes = 0, commit = 0, nprop = 0;
  int32_t next[NN] = {}, match[NN] = {};
  int32_t egen = 0, hgen = 0;
  void reset_volatile() {
    role = FOLLOWER; votes = 0; commit = 0; nprop = 0;
    std::memset(next, 0, sizeof next);
    std::memset(match, 0, sizeof match);
    egen = 0; hgen = 0;
  }
};

struct Sim {
  Rng rng;
  std::priority_queue<Ev, std::vector<Ev>, EvCmp> q;
  Node nd[NN];
  bool alive[NN];
  bool cut[NN][NN] = {};   // partition link matrix
  int32_t boot_gen[NN] = {};
  int64_t now = 0;
  int64_t events = 0, elections = 0;
  int32_t max_commit = 0;

  void push(Kind k, int64_t at, int n, int src, int tag,
            const int32_t* pl, int npl) {
    Ev e{};
    e.deadline = at;
    e.pri = (uint32_t)rng.next();
    e.kind = k; e.node = (int32_t)n; e.src = (int32_t)src;
    e.tag = tag; e.gen = boot_gen[n];
    if (pl) std::memcpy(e.payload, pl, npl * sizeof(int32_t));
    q.push(e);
  }
  void send(int from, int to, int tag, const int32_t* pl, int npl) {
    if (cut[from][to]) return;                 // clogged link
    if (rng.bernoulli(LOSS)) return;           // packet loss
    int64_t lat = rng.range(LAT_LO, LAT_HI);
    push(MSG, now + lat, to, from, tag, pl, npl);
  }
  void set_timer(int n, int64_t delay, int tag, const int32_t* pl, int npl) {
    push(TIMER, now + delay, n, n, tag, pl, npl);
  }

  int32_t last_term(const Node& s) {
    return s.log_len > 0 ? s.log_term[s.log_len - 1] : 0;
  }
  void arm_election(int n) {
    Node& s = nd[n];
    s.egen++;
    int32_t pl[1] = {s.egen};
    set_timer(n, rng.range(E_MIN, E_MAX), T_ELECTION, pl, 1);
  }
  void node_init(int n) {  // boot / restart (Raft.init)
    arm_election(n);
    int32_t pl[1] = {0};
    set_timer(n, rng.range(0, PROP), T_PROPOSE, pl, 1);
  }

  void on_timer(int n, int tag, const int32_t* pl) {
    Node& s = nd[n];
    if (tag == T_ELECTION) {
      if (pl[0] != s.egen || s.role == LEADER) return;
      s.term++; s.role = CANDIDATE; s.voted_for = n; s.votes = 1;
      elections++;
      arm_election(n);  // candidate retries on split vote
      int32_t rv[3] = {s.term, s.log_len, last_term(s)};
      for (int p = 0; p < NN; p++)
        if (p != n) send(n, p, RV, rv, 3);
    } else if (tag == T_HEARTBEAT) {
      if (pl[0] != s.hgen || s.role != LEADER) return;
      for (int p = 0; p < NN; p++) {
        if (p == n) continue;
        int32_t nxt = s.next[p];
        int32_t prev_t = nxt > 0 ? s.log_term[std::min(nxt - 1, L - 1)] : 0;
        int32_t cnt = std::min(std::max(s.log_len - nxt, 0), 1);
        int32_t ei = std::min(std::max(nxt, 0), L - 1);
        int32_t ae[7] = {s.term, nxt, prev_t, s.commit, cnt,
                         s.log_term[ei], s.log_cmd[ei]};
        send(n, p, AE, ae, 7);
      }
      int32_t hb[1] = {s.hgen};
      set_timer(n, HB, T_HEARTBEAT, hb, 1);
    } else if (tag == T_PROPOSE) {
      if (s.role == LEADER && s.nprop < N_CMDS && s.log_len < L) {
        s.log_term[s.log_len] = s.term;
        s.log_cmd[s.log_len] = n * 65536 + s.nprop;
        s.log_len++;
        s.match[n] = s.log_len;
        s.nprop++;
      }
      int32_t pr[1] = {0};
      set_timer(n, PROP, T_PROPOSE, pr, 1);  // re-arms unconditionally
    }
  }

  void advance_commit(Node& s) {  // §5.4.2: current-term entries only
    for (int32_t k = s.commit; k < s.log_len; k++) {
      if (s.log_term[k] != s.term) continue;
      int c = 0;
      for (int p = 0; p < NN; p++) c += s.match[p] >= k + 1;
      if (c >= MAJ) s.commit = k + 1;
    }
  }

  void on_message(int n, int src, int tag, const int32_t* pl) {
    Node& s = nd[n];
    int32_t term_in = pl[0];
    if (term_in > s.term) {  // §5.1 step-down
      s.term = term_in; s.role = FOLLOWER; s.voted_for = -1;
    }
    bool reset_el = false;
    if (tag == RV) {
      int32_t clen = pl[1], clast = pl[2], mylast = last_term(s);
      bool log_ok = clast > mylast || (clast == mylast && clen >= s.log_len);
      bool grant = term_in == s.term && log_ok &&
                   (s.voted_for == -1 || s.voted_for == src);
      if (grant) { s.voted_for = src; reset_el = true; }
      int32_t rvr[2] = {s.term, grant};
      send(n, src, RVR, rvr, 2);
    } else if (tag == RVR) {
      if (s.role == CANDIDATE && term_in == s.term && pl[1] == 1) {
        s.votes++;
        if (s.votes == MAJ) {  // become leader, exactly once
          s.role = LEADER;
          for (int p = 0; p < NN; p++) { s.next[p] = s.log_len; s.match[p] = 0; }
          s.match[n] = s.log_len;
          s.hgen++;
          int32_t hb[1] = {s.hgen};
          set_timer(n, 0, T_HEARTBEAT, hb, 1);
        }
      }
    } else if (tag == AE) {
      int32_t prev = pl[1], prev_t = pl[2], lcommit = pl[3], cnt = pl[4];
      bool from_leader = term_in == s.term;
      if (from_leader && s.role == CANDIDATE) s.role = FOLLOWER;
      if (from_leader) reset_el = true;
      bool prev_ok = prev <= s.log_len &&
                     (prev == 0 || s.log_term[prev - 1] == prev_t);
      bool ok = from_leader && prev_ok && (cnt == 0 || prev < L);
      int32_t n_acc = 0;
      if (ok && cnt > 0) {
        int32_t e_term = pl[5], e_cmd = pl[6];
        if (prev < s.log_len && s.log_term[prev] != e_term)
          s.log_len = prev;  // §5.3 conflict truncation
        s.log_term[prev] = e_term;
        s.log_cmd[prev] = e_cmd;
        s.log_len = std::max(s.log_len, prev + 1);
        n_acc = 1;
      }
      // commit clamps to the VERIFIED prefix (Figure 2 "last new entry"),
      // not the local log length — same rule the engine unit-tests
      int32_t match = ok ? prev + n_acc : 0;
      if (ok) s.commit = std::max(s.commit, std::min(lcommit, match));
      int32_t aer[3] = {s.term, ok, match};
      send(n, src, AER, aer, 3);
    } else if (tag == AER) {
      if (s.role == LEADER && term_in == s.term) {
        bool succ = pl[1] == 1;
        int32_t mlen = pl[2];
        if (succ) {
          s.match[src] = std::max(s.match[src], mlen);
          s.next[src] = std::max(s.next[src], s.match[src]);
        } else {
          s.next[src] = std::max(s.next[src] - 1, 0);
        }
        advance_commit(s);
      }
    }
    max_commit = std::max(max_commit, s.commit);
    if (reset_el) arm_election(n);
  }

  void on_super(int op, const int32_t* pl) {
    if (op == KILL_RANDOM || op == RESTART_RANDOM) {
      bool want = op == KILL_RANDOM;  // kill among alive, restart among dead
      int cand[NN], nc = 0;
      for (int p = 0; p < NN; p++)
        if (alive[p] == want) cand[nc++] = p;
      if (!nc) return;
      int t = cand[rng.next() % nc];
      boot_gen[t]++;  // clears the node's queued events (lazy drop on pop)
      if (op == KILL_RANDOM) {
        alive[t] = false;
      } else {
        alive[t] = true;
        nd[t].reset_volatile();  // process memory; log/term/vote persist
        node_init(t);
      }
    } else if (op == PARTITION) {
      int32_t a = pl[0], b = pl[1];
      for (int i = 0; i < NN; i++)
        for (int j = 0; j < NN; j++) {
          bool ia = i == a || i == b, ja = j == a || j == b;
          cut[i][j] = ia != ja;
        }
    } else if (op == HEAL) {
      std::memset(cut, 0, sizeof cut);
    }
  }

  void run(int64_t max_events) {
    for (int n = 0; n < NN; n++) { alive[n] = true; }
    for (int n = 0; n < NN; n++) push(SUPER, 0, n, 0, 0, nullptr, 0);  // boot
    for (int t = 0; t < 8; t++) {  // the flagship's rolling chaos script
      int32_t ab[2] = {t % NN, (t + 1) % NN};
      push(SUPER, (1 + t) * SEC, 0, 0, KILL_RANDOM, nullptr, 0);
      push(SUPER, (1 + t) * SEC + 400 * MS, 0, 0, RESTART_RANDOM, nullptr, 0);
      push(SUPER, (1 + t) * SEC + 600 * MS, 0, 0, PARTITION, ab, 2);
      push(SUPER, (1 + t) * SEC + 900 * MS, 0, 0, HEAL, nullptr, 0);
    }
    while (events < max_events && !q.empty()) {
      Ev e = q.top();
      q.pop();
      if (e.kind != SUPER && e.gen != boot_gen[e.node])
        continue;  // queue cleared at kill — removed, not dispatched
      now = std::max(now, e.deadline);
      events++;
      if (e.kind == SUPER) {
        if (e.tag == 0) node_init(e.node);  // boot row
        else on_super(e.tag, e.payload);
      } else if (!alive[e.node]) {
        // dispatched as a drop (messages to dead nodes still pop)
      } else if (e.kind == MSG) {
        on_message(e.node, e.src, e.tag, e.payload);
      } else {
        on_timer(e.node, e.tag, e.payload);
      }
    }
  }
};

}  // namespace

extern "C" void simloop_run(uint64_t seed, int64_t max_events,
                            int64_t* out /* [4] */) {
  Sim* sim = new Sim();
  sim->rng.s = seed * 0x9e3779b97f4a7c15ull + 0x2545f4914f6cdd1dull;
  auto t0 = std::chrono::steady_clock::now();
  sim->run(max_events);
  auto t1 = std::chrono::steady_clock::now();
  out[0] = sim->events;
  out[1] = std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
               .count();
  out[2] = sim->max_commit;
  out[3] = sim->elections;
  delete sim;
}

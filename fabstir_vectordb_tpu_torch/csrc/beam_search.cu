// K11: batched beam search at one HNSW layer, with the JAX package's step
// rule.
//
// Replaces the JAX package's _beam_search_jit (index/hnsw.py:312, with
// beam_search_kernel :291 and _dedup_sorted :481). Per query: a pool of at
// most ef (distance, id) entries sorted ascending, with expansion flags.
// Each step takes the W best unexpanded entries of finite distance (the
// pool is sorted, so the first W such positions); it stops when there is
// none or the pool is full and the best of them is above the pool's worst.
// The chosen entries are flagged, their adjacency lists gathered (-1
// padded), and a neighbour enters only if it is >= 0, not in the pool, not
// repeated earlier in this step's list, and unmasked. The survivors merge
// into the pool as a stable sort of [pool, new] cut to ef would: an equal
// distance keeps the pool's entry first, and new entries keep their list
// order. With a result mask, the survivors that pass it merge the same way
// into a separate result list, whose repeated ids are dropped at the end
// (keep the first): an eligible id that left the pool and comes back as a
// candidate is scored and merged into the results again, as the reference
// merges it. At most max_iters steps.
//
// Rows are f32 or bf16 (a bf16 serving mirror), upcast exactly, with the
// f32 query and the mirror's f32 x_sq: the reference's _gather_dists
// (index/hnsw.py:239) on a bf16 mirror. At a layer above 0 (up_offset
// given) a node's list is nbrs_up[up_offset[id] + layer - 1]; queries whose
// active flag is 0 keep their start set (the per-layer link plan's queries
// below the layer).
//
// What bounds it on the H100: a step depends on the step before, so a
// query is a chain of dependent global reads (its adjacency lists, then
// the rows they name): at B = 1 it is latency-bound, ~2 round trips a
// step for ~ef / W + 32 steps; at B = 128 and 1,024 the chains of many
// queries overlap, and each step's bookkeeping (membership test, ranking,
// merge) and the row bytes share the card.
//
// Design: one block a query, of 1 to 8 warps (the host's plan:
// index/hnsw.py beam_plan, so that each warp gathers about 16 rows a step
// and B x warps fills the card without a second wave); the kernel is
// compiled for 32, 128 or 256 candidates a step (a lane holds 1, 4 or 8)
// and for lists in shared memory (while the query and they fit in
// LIST_SMEM bytes) or in a global scratch row of the same layout. A query
// keeps its lists (pool and results) and a map of the ids it has scored:
// distance, and whether unmasked, eligible, in the pool now. A pass (the
// start set's ids, then each step's) crosses four block barriers, and
// those of a merge where an entry enters a list:
//  * Warp 0 takes the first W unexpanded positions by ballots, from the
//    first position that may be unexpanded (`first`: nothing below the
//    last parent or the nearest new entry changes), reads the parents'
//    lists, takes the candidates 32 at a time in list order, drops each id
//    repeated earlier in its 32 (31 shuffles) and looks the rest up in the
//    map, which takes each new id as it goes (so a repeat in a later 32 is
//    found there): an id never scored is scored; one in the pool is
//    skipped; one scored before and outside the pool now cannot enter it
//    again (its distance is at or above a worst that never rises, and a
//    tie goes after the pool's entries), so it is offered to the results
//    alone, at its distance then, if eligible: the reference scores it
//    again and merges it there again, and so does this kernel, without the
//    row. The other warps wait at the barrier (eight warps doing the same
//    work took ~7,500 cycles a step at the serve shape). The map is
//    rebuilt from the pool before a pass could fill half its slots (the
//    ids outside the pool are forgotten and scored again if they come
//    back).
//  * The new ids' rows are spread over the warps, 8 rows a warp at a time
//    with all their loads in flight, the row mask, the result mask and
//    x_sq read beside them; the parents are flagged expanded. Barrier.
//  * Each offered survivor's rank by (distance, list order) among the new
//    pool and the new result entries, written in that order. Barrier.
//  * The new ids' distances and states go into the map. Where an entry
//    enters a list (its nearest new distance below a full list's worst),
//    the list is merged in place: from the first new position up, a list
//    entry moves up by the new entries strictly below it (a binary
//    search), a block's width at a time from the top, and a new entry goes
//    after the list entries at or below it; an entry pushed out of the
//    pool leaves it in the map. Barrier.
// At the serve shape a step takes ~14,000 cycles on an H100
// (scripts/time_tile_routes.py --split k11, its "stats" variant): warp 0's
// parents and candidates ~6,800 (the parents' list reads, a dependent
// global round trip), the gathers ~2,500, the rank and merges ~5,000.
#include "common.cuh"

namespace fvdb {

constexpr int CAP = 256;           // candidates a step: W x list width
constexpr int BS_G = 8;            // rows a warp gathers at once
constexpr int BS_MAX_WARPS = 8;    // warps a query (a block)
constexpr int LIST_SMEM = 32768;   // query + lists in shared memory up to

// A query's lists: pool (d, id, expanded) and results (d, id), sorted.
struct Lists {
  float* pd;
  int* pid;
  float* rd;
  int* rid;
  uint8_t* pexp;
};

// A query's map of the ids it has scored (open addressing, key -1 empty):
// each one's distance and state (SEEN_POOL: in the pool now; SEEN_OK:
// unmasked; SEEN_ELIG: unmasked and in the result mask; SEEN_TAKEN: a
// candidate of this pass already).
struct Seen {
  int* key;
  float* d;
  uint8_t* st;
};
constexpr uint8_t SEEN_POOL = 1, SEEN_OK = 2, SEEN_ELIG = 4, SEEN_TAKEN = 8;

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }
// slots of the map: a power of two >= max(4 ef, 1,024), so that the
// pool and a pass's 256 candidates at most stay within half of them; it
// is rebuilt from the pool before a pass would pass that
__host__ __device__ inline int seen_slots(int ef) {
  int h = 1024;
  while (h < 4 * ef) h *= 2;
  return h;
}
__host__ __device__ inline size_t list_bytes(int ef) {
  return 4 * round16((size_t)4 * ef) + round16((size_t)ef) +
         (size_t)9 * seen_slots(ef);
}
__device__ inline Lists carve(unsigned char* base, int ef) {
  const size_t a = round16((size_t)4 * ef);
  Lists L;
  L.pd = reinterpret_cast<float*>(base);
  L.pid = reinterpret_cast<int*>(base + a);
  L.rd = reinterpret_cast<float*>(base + 2 * a);
  L.rid = reinterpret_cast<int*>(base + 3 * a);
  L.pexp = base + 4 * a;
  return L;
}
__device__ inline Seen carve_seen(unsigned char* base, int ef) {
  const int slots = seen_slots(ef);
  base += 4 * round16((size_t)4 * ef) + round16((size_t)ef);
  Seen S;
  S.key = reinterpret_cast<int*>(base);
  S.d = reinterpret_cast<float*>(base + (size_t)4 * slots);
  S.st = base + (size_t)8 * slots;
  return S;
}

__device__ __forceinline__ int hash_of(int id, int slots) {
  return (int)(((unsigned)id * 2654435761u) >> 16) & (slots - 1);
}
// id's slot in the map, or -1 (linear probing up to an empty slot; the
// map holds at most half its slots, so a probe that meets no empty slot
// is a fault in the kernel's bookkeeping: it traps instead of holding the
// card)
__device__ __forceinline__ int seen_find(const int* key, int slots, int id) {
  int s = hash_of(id, slots);
  for (int n = 0; n < slots; ++n, s = (s + 1) & (slots - 1)) {
    const int k = key[s];
    if (k == id) return s;
    if (k < 0) return -1;
  }
  __trap();
}
// A slot for id (not in the map yet).
__device__ __forceinline__ int seen_claim(int* key, int slots, int id) {
  int s = hash_of(id, slots);
  for (int n = 0; atomicCAS(key + s, -1, id) != -1;
       ++n, s = (s + 1) & (slots - 1))
    if (n == slots) __trap();
  return s;
}

// Entries of ld[0, n) (sorted ascending) at or below v.
__device__ __forceinline__ int count_le(const float* ld, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ld[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// This thread's index among the block's threads whose `pred` holds (in
// thread order) and their count in *total, for any block of whole warps.
__device__ __forceinline__ int team_rank(bool pred, int* s_wcnt, int* total) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(FULL, pred);
  __syncthreads();  // s_wcnt is free from its last use
  if (lane == 0) s_wcnt[w] = __popc(bal);
  __syncthreads();
  int off = 0, tot = 0;
  for (int i = 0; i < nw; ++i) {
    const int c = s_wcnt[i];
    off += i < w ? c : 0;
    tot += c;
  }
  *total = tot;
  return off + __popc(bal & ((1u << lane) - 1u));
}

// Merge nn new entries (nd / nid, sorted by (distance, list order)) into
// the sorted list (ld, lid[, lexp]) of n entries in place, as a stable sort
// of [list, new] cut to ef: an entry moves up by the new entries strictly
// below it (a binary search), from the top down a block's width at a time
// (every entry of a chunk read before any is written; an entry only moves
// up, past the chunks already moved), and only the entries from the first
// new position up move; a new entry goes after the list entries at or
// below it (its place taken before anything moves). With seen (the pool),
// an entry pushed out leaves the pool in the map. Every thread of the
// block calls it; it ends with a barrier.
__device__ __forceinline__ void merge_in_place(
    float* ld, int* lid, uint8_t* lexp, int n, const float* __restrict__ nd,
    const int* __restrict__ nid, int nn, int ef, const Seen* seen,
    int slots) {
  const int t = threadIdx.x, NTH = blockDim.x;
  const int first_ins = count_le(ld, n, nd[0]);
  int pos[CAP / 32];  // this thread's new entries' places
#pragma unroll
  for (int k = 0; k < CAP / 32; ++k) {
    const int j = t + k * NTH;
    pos[k] = j < nn ? count_le(ld, n, nd[j]) + j : ef;
  }
  for (int top = n; top > first_ins;) {
    const int lo = max(first_ins, top - NTH);
    const int p = lo + t;
    float d = 0.f;
    int id = -1, dst = ef;
    uint8_t ex = 0;
    if (p < top) {
      d = ld[p];
      id = lid[p];
      if (lexp) ex = lexp[p];
      int a = 0, b = nn;  // new entries strictly below d
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (nd[mid] < d) a = mid + 1; else b = mid;
      }
      dst = p + a;
    }
    __syncthreads();
    if (p < top) {
      if (dst < ef) {
        ld[dst] = d;
        lid[dst] = id;
        if (lexp) lexp[dst] = ex;
      } else if (seen) {
        const int s = seen_find(seen->key, slots, id);
        if (s >= 0) seen->st[s] &= (uint8_t)~SEEN_POOL;
      }
    }
    __syncthreads();
    top = lo;
  }
#pragma unroll
  for (int k = 0; k < CAP / 32; ++k) {
    const int j = t + k * NTH;
    if (j < nn && pos[k] < ef) {
      ld[pos[k]] = nd[j];
      lid[pos[k]] = nid[j];
      if (lexp) lexp[pos[k]] = 0;
    }
  }
  __syncthreads();
}

// KC: 32s of candidates a lane holds (1, 4 or 8; W x Mw <= 32 KC).
// SMEM: the lists in shared memory, else in the global scratch.
template <typename T, int KC, bool SMEM>
__global__ void __launch_bounds__(BS_MAX_WARPS * 32, 2) beam_search_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const int* __restrict__ adj,
    int adj_rows, int Mw, const int* __restrict__ up_offset, int layer,
    const float* __restrict__ q, int D, const int* __restrict__ start, int S,
    const uint8_t* __restrict__ active,
    const uint8_t* __restrict__ result_mask, int ef, int max_iters, int W,
    unsigned char* __restrict__ scratch, float* __restrict__ out_d,
    int* __restrict__ out_id) {
  constexpr int NC = 32 * KC;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int s_id[NC];       // this pass's survivors, in list order
  __shared__ int s_slot[NC];     // ... their map slots
  __shared__ uint8_t s_new[NC];  // ... 1: scored now, 0: from the map
  __shared__ float s_d[NC];      // ... their distances
  __shared__ uint8_t s_fl[NC];   // ... 1: offered to the pool, 2: to the
                                 // results
  __shared__ float s_nd[NC];     // the new pool entries by (distance,
  __shared__ int s_nid[NC];      // list order)
  __shared__ int s_rank[NC];     // ... a survivor's place there
  __shared__ float s_ed[NC];     // the new result entries, the same
  __shared__ int s_eid[NC];
  __shared__ int s_cnt[2];       // new pool and result entries
  __shared__ int s_sel[NC];      // pool positions expanded this step
  __shared__ int s_ctl[4];       // warp 0's stop, nv, nsel, sel_last
  __shared__ int s_wcnt[BS_MAX_WARPS];
  __shared__ float s_qsq;

  const int b = blockIdx.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int NTH = blockDim.x, NW = NTH >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const bool has_res = result_mask != nullptr;
  const bool runs = active == nullptr || active[b];
  const int slots = seen_slots(ef);
  float* qs = reinterpret_cast<float*>(dyn);
  const size_t q_bytes = round16((size_t)D * 4);
  unsigned char* lists =
      SMEM ? dyn + q_bytes : scratch + (size_t)b * list_bytes(ef);
  const Lists L = carve(lists, ef);
  const Seen seen = carve_seen(lists, ef);

  for (int d = t; d < D; d += NTH) qs[d] = q[(size_t)b * D + d];
  for (int i = t; i < slots; i += NTH) seen.key[i] = -1;
  __syncthreads();
  if (w == 0) {
    const float s = warp_row_sq(qs, D);
    if (lane == 0) s_qsq = s;
  }
  __syncthreads();
  const float q_sq = s_qsq;
  // uniform across the block: every thread counts the same entries; the
  // pool's positions below `first` are all expanded; warp 0 counts the
  // map's taken slots in `filled`
  int pool_n = 0, res_n = 0, first = 0, filled = 0;
  const int s_eff = min(S, ef);
  const int* st = start + (size_t)b * S;

  // Each pass offers candidates to the lists: first the start set (its
  // first min(S, ef) ids, NC at a time), then a step's W x Mw neighbours.
  for (int s0 = 0, it = 0;;) {
    const bool from_start = s0 < s_eff;
    if (!from_start && (!runs || it >= max_iters)) break;
    // warp 0 takes the pass's parents and candidates; the others wait at
    // the barrier (eight warps doing the same shuffles and matches took
    // ~7,500 cycles a pass at the serve shape)
    if (w == 0) {
      int nc = 0, nsel = 0, sel_last = -1, stop = 0;
      if (from_start) {
        nc = min(NC, s_eff - s0);
      } else {
        // the first W unexpanded positions of finite distance, from
        // `first`
        for (int p0 = first; p0 < pool_n && nsel < W; p0 += 32) {
          const int p = p0 + lane;
          unsigned bal = __ballot_sync(
              FULL, p < pool_n && !L.pexp[p] && L.pd[p] < INFINITY);
          while (bal && nsel < W) {
            const int pos = p0 + __ffs(bal) - 1;
            bal &= bal - 1;
            if (lane == 0) s_sel[nsel] = pos;
            sel_last = pos;
            ++nsel;
          }
        }
        __syncwarp();
        stop = nsel == 0 ||
               (pool_n == ef && L.pd[s_sel[0]] > L.pd[ef - 1]);
        nc = stop ? 0 : nsel * Mw;
      }
      if (filled + nc > slots / 2) {
        // the map rebuilt from the pool: the ids outside it are
        // forgotten, and scored again if they come back, as the
        // reference scores them
        for (int i = lane; i < slots; i += 32) seen.key[i] = -1;
        __syncwarp();
        for (int p = lane; p < pool_n; p += 32) {
          const int id = L.pid[p];
          const int s = seen_claim(seen.key, slots, id);
          seen.d[s] = L.pd[p];
          seen.st[s] = SEEN_POOL | SEEN_OK |
                       (!has_res || result_mask[id] ? SEEN_ELIG : 0);
        }
        __syncwarp();
        filled = pool_n;
      }
      // the candidates, 32 at a time in list order, a lane each: an id
      // repeated earlier in the list is dropped (within its 32 by a match,
      // against the 32s before by the map, which takes each new id as it
      // goes); an id never scored is scored; one in the pool is skipped;
      // one scored before and outside the pool now cannot enter it again
      // (its distance is at or above a worst that never rises, and a tie
      // goes after the pool's entries), so it is offered to the results
      // alone, at its distance then, if eligible: the reference scores it
      // again and merges it there again, and so does this kernel, without
      // its row
      int cid[KC];  // every list read before any is looked up
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int i = 32 * k + lane;
        int id = -1;
        if (i < nc) {
          if (from_start) {
            id = st[s0 + i];
          } else {
            const int nid = L.pid[s_sel[i / Mw]];
            long long row = nid;
            if (up_offset) row = (long long)up_offset[nid] + layer - 1;
            row = min(max(row, 0ll), (long long)adj_rows - 1);
            id = adj[row * Mw + i % Mw];
          }
        }
        cid[k] = id;
      }
      int nv = 0;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (32 * k >= max(nc, 1)) break;
        const int id = cid[k];
        bool dup = false;  // the same id in a lower lane (no branch: the
#pragma unroll             // shuffles pipeline)
        for (int r = 1; r < 32; ++r) {
          const int o = __shfl_sync(FULL, id, (lane - r) & 31);
          dup |= lane >= r && o == id;
        }
        int slot = -1;
        bool take = false, fresh = false;
        if (id >= 0 && !dup) {
          slot = seen_find(seen.key, slots, id);
          if (slot < 0) {
            slot = seen_claim(seen.key, slots, id);
            seen.st[slot] = SEEN_TAKEN;
            take = fresh = true;
          } else if (has_res && seen.st[slot] == (SEEN_OK | SEEN_ELIG)) {
            seen.st[slot] |= SEEN_TAKEN;
            take = true;
          }
        }
        __syncwarp();  // this 32's ids in the map before the next 32
        const unsigned bal = __ballot_sync(FULL, take);
        if (take) {
          const int j = nv + __popc(bal & lt);
          s_id[j] = id;
          s_slot[j] = slot;
          s_new[j] = fresh;
        }
        nv += __popc(bal);
        filled += __popc(__ballot_sync(FULL, fresh));
      }
      if (lane == 0) {
        s_ctl[0] = stop;
        s_ctl[1] = nv;
        s_ctl[2] = nsel;
        s_ctl[3] = sel_last;
      }
    }
    __syncthreads();
    if (s_ctl[0]) break;
    const int nv = s_ctl[1], nsel = s_ctl[2], sel_last = s_ctl[3];
    if (!from_start) ++it;
    // the new ids' distances, BS_G survivors a warp at a time, the masks
    // beside the rows; the others' from the map
    for (int base = w * BS_G; base < nv; base += NW * BS_G) {
      int rows[BS_G];
#pragma unroll
      for (int g = 0; g < BS_G; ++g)
        rows[g] = base + g < nv && s_new[base + g] ? s_id[base + g] : -1;
      const int j = base + lane;
      const bool mine = lane < BS_G && j < nv;
      const int r = mine && s_new[j] ? s_id[j] : -1;
      uint8_t mk = 0, rm = 1;
      float xs = 0.f;
      if (r >= 0) {
        mk = mask[r];
        if (has_res) rm = result_mask[r];
        xs = x_sq[r];
      }
      float dots[BS_G];
      warp_dots<BS_G>(qs, x, rows, D, dots);
      float dl = 0.f;
#pragma unroll
      for (int g = 0; g < BS_G; ++g)
        if (g == lane) dl = dots[g];
      if (r >= 0) {
        s_d[j] = sq_dist(q_sq, dl, xs);
        s_fl[j] = mk ? (rm ? 3 : 1) : 0;
      } else if (mine) {
        s_d[j] = seen.d[s_slot[j]];
        s_fl[j] = 2;
      }
    }
    // the parents come out expanded (flagged before anything moves)
    for (int i = t; i < nsel; i += NTH) L.pexp[s_sel[i]] = 1;
    __syncthreads();
    // the new entries sorted by (distance, list order): each offered
    // survivor's rank among them
    for (int j = t; j < nv; j += NTH) {
      const int f = s_fl[j];
      if (!f) continue;
      const float d = s_d[j];
      int rp = 0, re = 0;
      for (int i = 0; i < nv; ++i) {
        const int fi = s_fl[i];
        const float di = s_d[i];
        const bool before = di < d || (di == d && i < j);
        rp += (fi & 1) && before;
        re += (fi & 2) && before;
      }
      if (f & 1) {
        s_nd[rp] = d;
        s_nid[rp] = s_id[j];
        s_rank[j] = rp;
      }
      if (f & 2) {
        s_ed[re] = d;
        s_eid[re] = s_id[j];
      }
    }
    if (w == 0) {
      int n1 = 0, n2 = 0;
      for (int j0 = 0; j0 < nv; j0 += 32) {
        const int f = j0 + lane < nv ? s_fl[j0 + lane] : 0;
        n1 += __popc(__ballot_sync(FULL, f & 1));
        n2 += __popc(__ballot_sync(FULL, f & 2));
      }
      if (lane == 0) {
        s_cnt[0] = n1;
        s_cnt[1] = n2;
      }
    }
    __syncthreads();
    // the new entries that enter (a full list keeps its entries on a tie)
    const int n_new = s_cnt[0] > 0 && (pool_n < ef || L.pd[ef - 1] > s_nd[0])
                          ? s_cnt[0] : 0;
    const int n_el = s_cnt[1] > 0 && (res_n < ef || L.rd[ef - 1] > s_ed[0])
                         ? s_cnt[1] : 0;
    // the survivors' states in the map: a new id's distance, flags and
    // place (in the pool if it enters it, as merge_in_place puts it)
    for (int j = t; j < nv; j += NTH) {
      const int s = s_slot[j];
      if (!s_new[j]) {
        seen.st[s] &= (uint8_t)~SEEN_TAKEN;
        continue;
      }
      const int f = s_fl[j];
      const bool in_pool = (f & 1) && n_new > 0 &&
                           count_le(L.pd, pool_n, s_d[j]) + s_rank[j] < ef;
      seen.d[s] = s_d[j];
      seen.st[s] = (in_pool ? SEEN_POOL : 0) | (f & 1 ? SEEN_OK : 0) |
                   (f & 2 ? SEEN_ELIG : 0);
    }
    // every position up to the last parent is expanded now, and nothing
    // below the nearest new entry moves
    first = max(first, sel_last + 1);
    if (n_new > 0) {
      first = min(first, count_le(L.pd, pool_n, s_nd[0]));
      merge_in_place(L.pd, L.pid, L.pexp, pool_n, s_nd, s_nid, n_new, ef,
                     &seen, slots);
      pool_n = min(ef, pool_n + n_new);
    }
    if (n_el > 0) {
      merge_in_place(L.rd, L.rid, nullptr, res_n, s_ed, s_eid, n_el, ef,
                     nullptr, slots);
      res_n = min(ef, res_n + n_el);
    }
    if (from_start) s0 += NC;
    __syncthreads();
  }

  // out: the results (or the pool), repeated ids dropped, (+inf, -1) padded
  const int n = has_res ? res_n : pool_n;
  const float* ld = has_res ? L.rd : L.pd;
  const int* lid = has_res ? L.rid : L.pid;
  float* od = out_d + (size_t)b * ef;
  int* oi = out_id + (size_t)b * ef;
  int written = 0;
  for (int j0 = 0; j0 < n; j0 += NTH) {
    const int j = j0 + t;
    bool keep = j < n;
    float dj = 0.f;
    int ij = -1;
    if (keep) {
      dj = ld[j];
      ij = lid[j];
      // the pool never holds an id twice; the results can
      for (int i = 0; has_res && keep && i < j; ++i) keep = lid[i] != ij;
    }
    int cnt;
    const int r = team_rank(keep, s_wcnt, &cnt);
    if (keep) {
      od[written + r] = dj;
      oi[written + r] = ij;
    }
    written += cnt;
  }
  for (int j = written + t; j < ef; j += NTH) {
    od[j] = INFINITY;
    oi[j] = -1;
  }
}

}  // namespace fvdb

// Per query bytes of global scratch the kernel needs (0: its lists fit
// shared memory).
FVDB_EXPORT long long fvdb_beam_scratch_bytes(int D, int ef) {
  using namespace fvdb;
  return round16((size_t)D * 4) + list_bytes(ef) <= (size_t)LIST_SMEM
             ? 0
             : (long long)list_bytes(ef);
}

namespace fvdb {

template <typename T>
cudaError_t beam_search(const T* x, const float* x_sq, const uint8_t* mask,
                        const int* adj, int adj_rows, int Mw,
                        const int* up_offset, int layer, const float* q,
                        int B, int D, const int* start, int S,
                        const uint8_t* active, const uint8_t* result_mask,
                        int ef, int max_iters, int W, int warps,
                        unsigned char* scratch, float* out_d, int* out_id,
                        cudaStream_t stream) {
  const bool in_smem = fvdb_beam_scratch_bytes(D, ef) == 0;
  if (!in_smem && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t q_bytes = round16((size_t)D * 4);  // the f32 query
  const int smem = (int)(in_smem ? q_bytes + list_bytes(ef) : q_bytes);
  const int kc = (W * Mw + 31) / 32;
  auto launch = [&](auto kernel, int* cap) {
    cudaError_t e = raise_smem_cap(reinterpret_cast<const void*>(kernel),
                                   smem, cap);
    if (e != cudaSuccess) return e;
    kernel<<<B, 32 * warps, smem, stream>>>(
        x, x_sq, mask, adj, adj_rows, Mw, up_offset, layer, q, D, start, S,
        active, result_mask, ef, max_iters, W, in_smem ? nullptr : scratch,
        out_d, out_id);
    return cudaGetLastError();
  };
  static int cap[6][64];
  if (in_smem) {
    if (kc <= 1) return launch(beam_search_kernel<T, 1, true>, cap[0]);
    if (kc <= 4) return launch(beam_search_kernel<T, 4, true>, cap[1]);
    return launch(beam_search_kernel<T, 8, true>, cap[2]);
  }
  if (kc <= 1) return launch(beam_search_kernel<T, 1, false>, cap[3]);
  if (kc <= 4) return launch(beam_search_kernel<T, 4, false>, cap[4]);
  return launch(beam_search_kernel<T, 8, false>, cap[5]);
}

}  // namespace fvdb

// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask [N] (uint8); adj
// [adj_rows, Mw]: nbrs0 (with up_offset == null) or nbrs_up read at
// up_offset[id] + layer - 1; q [B, D], start [B, S] int32 (-1 padded),
// active [B] uint8 or null, result_mask [N] uint8 or null; scratch [B,
// fvdb_beam_scratch_bytes] or null when that is 0; out_d / out_id [B, ef].
// W x Mw <= 256; warps (1-8) a query.
FVDB_EXPORT int fvdb_beam_search(
    const void* x, int x_bf16, const float* x_sq, const uint8_t* mask,
    const int* adj, int adj_rows, int Mw, const int* up_offset, int layer,
    const float* q, int B, int D, const int* start, int S,
    const uint8_t* active, const uint8_t* result_mask, int ef, int max_iters,
    int W, int warps, unsigned char* scratch, float* out_d, int* out_id,
    cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || D < 1 || ef < 1 || S < 1 || W < 1 || Mw < 1 || adj_rows < 1 ||
      W * Mw > CAP || warps < 1 || warps > BS_MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      x_bf16 ? beam_search<__nv_bfloat16>(
                   static_cast<const __nv_bfloat16*>(x), x_sq, mask, adj,
                   adj_rows, Mw, up_offset, layer, q, B, D, start, S, active,
                   result_mask, ef, max_iters, W, warps, scratch, out_d,
                   out_id, stream)
             : beam_search<float>(
                   static_cast<const float*>(x), x_sq, mask, adj, adj_rows,
                   Mw, up_offset, layer, q, B, D, start, S, active,
                   result_mask, ef, max_iters, W, warps, scratch, out_d,
                   out_id, stream));
}

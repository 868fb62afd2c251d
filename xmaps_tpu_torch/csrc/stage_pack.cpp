// Group staging on the host: the scan and the 1-word pack of
// xmaps_tpu_torch/io/prefetch.py (stage_compact_group), one call a group.
//
// A frame is a run of the decoder's records (EVENT_DTYPE: x u16, y u16,
// p i16, t i64, packed in 14 bytes), given by the address of its first
// record and its length; the fields are read with memcpy, at any alignment.
// Built with g++ by io/stage_pack.py; a plain C interface for ctypes.
//
// The scan reads a group's frames from memory and the pack reads them again;
// both passes wait on the loads more than they compute.  So each walks a
// frame's events as PARTS interleaved streams, each over its own share of
// them, which keeps more cache misses in flight than one stream does.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int PARTS = 4;

template <typename T>
inline T load(const char* p) {
  T v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

// The decoder's record: its stride and the offsets of y and t from x, fixed
// at compile time, so every load takes a constant offset.
constexpr int64_t STRIDE = 14, DY = 2, DT = 6;

// The record's x in the low half, its y in the high half: one 32-bit load.
inline uint32_t xy(const char* e) { return load<uint32_t>(e); }
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "xy reads x, y as one word");

// ts << shift of every offset d in [0, rng]: the round-half-to-even of
// d * scale / rng.  ts(d) >= v (v >= 1) exactly where 2 d scale >
// (2v - 1) rng, or equals it and v is even; so bin v - 1 runs up to the
// least such d, which is stepped from v to v + 1 by the quotient and
// remainder of 2 rng by 2 scale.  Costs scale steps and rng + 1 stores.
void tabulate(uint32_t* table, int64_t rng, int64_t scale, int32_t shift) {
  int64_t d0 = 0;
  if (scale > 0) {
    const int64_t den = 2 * scale, q_step = 2 * rng / den, r_step = 2 * rng % den;
    int64_t q = rng / den, r = rng % den;  // (2v - 1) rng by den, at v = 1
    for (int64_t v = 1; v <= scale && d0 <= rng; ++v) {
      const int64_t b = std::min(q + 1 - (r == 0 && v % 2 == 0), rng + 1);
      if (b > d0) {
        std::fill(table + d0, table + b, static_cast<uint32_t>(v - 1) << shift);
        d0 = b;
      }
      q += q_step;
      r += r_step;
      if (r >= den) {
        ++q;
        r -= den;
      }
    }
  }
  std::fill(table + d0, table + rng + 1, static_cast<uint32_t>(scale) << shift);
}

// The scan of one frame of m records at x, the first n of them staged: the
// min and max t of the n into lo and hi, and the bits set in some x (low
// half) or some y (high half) returned.  The accumulators are locals, which
// the loads (through char pointers) cannot alias.
uint32_t scan_frame(const char* x, int64_t m, int64_t n, int64_t& lo, int64_t& hi) {
  uint32_t any = 0;
  int64_t l = INT64_MAX, h = INT64_MIN;
  const int64_t part = n / PARTS;
  const char* e[PARTS];
  for (int j = 0; j < PARTS; ++j) e[j] = x + j * part * STRIDE;
  for (int64_t k = 0; k < part; ++k) {
    int64_t v[PARTS];
    for (int j = 0; j < PARTS; ++j) {
      any |= xy(e[j]);
      v[j] = load<int64_t>(e[j] + DT);
      e[j] += STRIDE;
    }
    l = std::min(l, *std::min_element(v, v + PARTS));
    h = std::max(h, *std::max_element(v, v + PARTS));
  }
  for (int64_t k = part * PARTS; k < m; ++k) {  // the rest, on from the last stream
    const char* last = e[PARTS - 1];
    any |= xy(last);
    if (k < n) {
      l = std::min(l, load<int64_t>(last + DT));
      h = std::max(h, load<int64_t>(last + DT));
    }
    e[PARTS - 1] += STRIDE;
  }
  lo = n ? l : 0;
  hi = n ? h : 0;
  return any;
}

// The words of one frame's first n records at x whose times lie in
// [lo, lo + rng], through the bins tabulated over that range.  An offset
// outside it (a t the scan did not see) is clamped to the table's end: a
// wrong word, never a read outside the table.
void pack_frame(const char* x, int64_t n, int64_t lo, int64_t rng, const uint32_t* table,
                int32_t bits_x, uint32_t* row) {
  const uint32_t y_mul = 1u << bits_x;  // a multiply: a shift by a variable costs more
  const uint64_t base = static_cast<uint64_t>(lo), top = static_cast<uint64_t>(rng);
  const auto word = [&](const char* e) {
    const uint64_t d = std::min(static_cast<uint64_t>(load<int64_t>(e + DT)) - base, top);
    const uint32_t v = xy(e);
    return table[d] | (v & 0xFFFF) | (v >> 16) * y_mul;
  };
  const int64_t part = n / PARTS;
  const char* e[PARTS];
  uint32_t* w[PARTS];
  for (int j = 0; j < PARTS; ++j) {
    e[j] = x + j * part * STRIDE;
    w[j] = row + j * part;
  }
  for (int64_t k = 0; k < part; ++k) {
    for (int j = 0; j < PARTS; ++j) {
      w[j][k] = word(e[j]);
      e[j] += STRIDE;
    }
  }
  for (int64_t k = part * PARTS; k < n; ++k) row[k] = word(x + k * STRIDE);
}

}  // namespace

extern "C" {

// For each of the f frames: whether every event's x and y fit bits_x and
// bits_y (over all len[i] events), and the min and max of t over the first
// min(len[i], capacity) events (0 and 0 for an empty frame).  Returns 1
// where every event of every frame fits, else 0.
int32_t xm_stage_scan(int32_t f, const int64_t* px, const int64_t* len, int64_t capacity,
                      int32_t bits_x, int32_t bits_y, int64_t* t_lo, int64_t* t_hi) {
  uint32_t any = 0;  // every bit set in some x (low half) or some y (high half)
  for (int32_t i = 0; i < f; ++i) {
    const int64_t m = len[i], n = m < capacity ? m : capacity;
    any |= scan_frame(reinterpret_cast<const char*>(px[i]), m, n, t_lo[i], t_hi[i]);
  }
  return (((any & 0xFFFF) >> bits_x) | ((any >> 16) >> bits_y)) == 0;
}

// For each of the f frames, write its first count[i] events into the row of
// capacity u32 words at rows[i] as ts << (bits_x + bits_y) | y << bits_x | x,
// and zero the rest of the row.  ts is the exact round-half-to-even of
// (t - t_lo) * t_px_scale / rng, rng = max(t_hi - t_lo, 1); the caller
// guarantees rng * t_px_scale < 2**52 and that every t lies in
// [t_lo, t_hi] (a t outside gives a wrong word, never a read or a write
// outside the frame, the table and the row).  No 64-bit divide an event:
// - where rng <= count[i] (a camera's frame: more events than µs), ts of
//   every offset is tabulated into ``table`` (at least capacity + 1 words)
//   and each event looks its offset up;
// - else the quotient q comes from a double reciprocal, the remainder r and
//   the rounding from integers: the product is within t_px_scale * 2**-52
//   of the true quotient, which lies at least 1 / rng below the next
//   integer, so q is the floor, or, where the quotient is a whole k, k - 1
//   with r = rng, which the rounding takes up to k.
void xm_stage_pack(int32_t f, const int64_t* px, const int64_t* count, const int64_t* rows,
                   int64_t capacity, int32_t bits_x, int32_t bits_y, int64_t t_px_scale,
                   const int64_t* t_lo, const int64_t* t_hi, uint32_t* table) {
  const int32_t shift = bits_x + bits_y;
  for (int32_t i = 0; i < f; ++i) {
    const char* x = reinterpret_cast<const char*>(px[i]);
    uint32_t* row = reinterpret_cast<uint32_t*>(rows[i]);
    const int64_t n = count[i], lo = t_lo[i];
    const int64_t rng = t_hi[i] - lo > 1 ? t_hi[i] - lo : 1;
    if (rng <= n) {
      tabulate(table, rng, t_px_scale, shift);
      pack_frame(x, n, lo, rng, table, bits_x, row);
    } else {
      const double inv = 1.0 / static_cast<double>(rng);
      for (int64_t k = 0; k < n; ++k) {
        const char* e = x + k * STRIDE;
        const int64_t num = (load<int64_t>(e + DT) - lo) * t_px_scale;
        const int64_t q = static_cast<int64_t>(static_cast<double>(num) * inv);
        const int64_t r = num - q * rng;
        row[k] = (static_cast<uint32_t>(q + ((2 * r + (q & 1)) > rng)) << shift) |
                 static_cast<uint32_t>(load<uint16_t>(e + DY)) << bits_x | load<uint16_t>(e);
      }
    }
    std::memset(row + n, 0, static_cast<size_t>(capacity - n) * sizeof(uint32_t));
  }
}

}  // extern "C"

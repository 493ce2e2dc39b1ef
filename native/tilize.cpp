// Host-side CSR -> sparse-tile conversion (native preprocessing, C++).
//
// Reference equivalent: the reference's matrix setup is C++/Eigen
// (SURVEY.md §3.1 R1/R10); the *compute* path here is XLA, but the one-off
// host-side format conversion for large matrices is native per SURVEY.md
// §3.1 ("host-side preprocessing may be C++-extension-backed"). Built lazily with g++ by blockcg/native.py;
// a numpy fallback provides identical results.
//
// Format: the n x n CSR matrix is cut into T x T dense tiles; only tiles
// containing nonzeros are emitted, sorted by (row_tile, col_tile), plus a
// "first tile in this row_tile" flag. Every row tile emits at least one
// tile (a zero tile if empty) so the accumulating kernel initializes every
// output block.
//
// Build: g++ -O3 -shared -fPIC -o libtilize.so tilize.cpp

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Pass 1: count tiles. Returns the total number of emitted tiles.
// row_tile_counts must have ceil(n/T) entries (zero-initialized by caller).
int64_t tilize_count(int64_t n, int64_t T,
                     const int64_t* indptr, const int32_t* indices,
                     int32_t* row_tile_counts) {
  const int64_t nrt = (n + T - 1) / T;
  const int64_t ntc = (n + T - 1) / T;
  std::vector<uint8_t> seen(ntc);
  int64_t total = 0;
  for (int64_t rt = 0; rt < nrt; ++rt) {
    std::memset(seen.data(), 0, ntc);
    int32_t cnt = 0;
    const int64_t r0 = rt * T;
    const int64_t r1 = r0 + T < n ? r0 + T : n;
    for (int64_t r = r0; r < r1; ++r) {
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t ct = indices[p] / T;
        if (!seen[ct]) { seen[ct] = 1; ++cnt; }
      }
    }
    if (cnt == 0) cnt = 1;  // explicit zero tile keeps the kernel's init
    row_tile_counts[rt] = cnt;
    total += cnt;
  }
  return total;
}

// Pass 2: fill tile data. Outputs must be preallocated with the pass-1
// total: tiles (total*T*T floats, zero-initialized), rt/ct/first (total).
void tilize_fill(int64_t n, int64_t T,
                 const int64_t* indptr, const int32_t* indices,
                 const float* data,
                 float* tiles, int32_t* rt_out, int32_t* ct_out,
                 int32_t* first_out) {
  const int64_t nrt = (n + T - 1) / T;
  const int64_t ntc = (n + T - 1) / T;
  std::vector<int64_t> slot_of(ntc);  // ct -> tile slot (this row tile)
  int64_t next = 0;
  for (int64_t rt = 0; rt < nrt; ++rt) {
    std::fill(slot_of.begin(), slot_of.end(), -1);
    const int64_t base = next;
    const int64_t r0 = rt * T;
    const int64_t r1 = r0 + T < n ? r0 + T : n;
    for (int64_t r = r0; r < r1; ++r) {
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t c = indices[p];
        const int64_t ct = c / T;
        int64_t slot = slot_of[ct];
        if (slot < 0) {
          slot = next++;
          slot_of[ct] = slot;
          rt_out[slot] = (int32_t)rt;
          ct_out[slot] = (int32_t)ct;
          first_out[slot] = (slot == base) ? 1 : 0;
        }
        tiles[slot * T * T + (r - r0) * T + (c - ct * T)] += data[p];
      }
    }
    if (next == base) {  // empty row tile: explicit zero tile
      rt_out[next] = (int32_t)rt;
      ct_out[next] = (int32_t)rt;
      first_out[next] = 1;
      ++next;
    }
  }
}

}  // extern "C"

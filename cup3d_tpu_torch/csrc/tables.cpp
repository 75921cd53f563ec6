// Native gather-table builder for the AMR halo lab (the port's own copy
// of the JAX package's native/tables.cpp, built by cup3d_tpu_torch/native.py
// with g++ at first use).
//
// This is the runtime role the reference implements in C++ as
// SynchronizerMPI_AMR::_Setup + StencilManager (main.cpp:1515-2545,
// 1322-1509): enumerate, per block, where every ghost cell of a halo'd
// scratch block comes from (same-level copy, 2:1 restriction from finer,
// or the coarse-scratch cells feeding the quadratic interpolation), with
// domain-boundary wrapping/clamping and per-component BC sign flips.
//
// The Python reference implementation is the numpy builder of
// cup3d_tpu_torch/grid/blocks.py (BlockGrid._build_lab_tables_numpy); this
// builder produces bit-identical tables (tests/test_torch_native_tables.py)
// and runs the per-block loops natively, the host-side hot path of every
// mesh adaptation.
//
// Plain C ABI consumed through ctypes.

#include <cstdint>
#include <cstring>

namespace {

struct Topo {
  int nb, bs, w, level_max;
  const int64_t *bpd;       // [3]
  const int32_t *bc;        // [3] 0 periodic, 1 wall, 2 freespace
  const int32_t *levels;    // [nb]
  const int64_t *ijk;       // [nb*3]
  const int32_t *slot_flat; // concatenated per-level dense maps
  const uint8_t *int_flat;  // concatenated per-level internal masks
  const int64_t *lvl_off;   // [level_max+1] offsets into the flat maps
  int64_t sentinel;         // nb*bs^3
};

inline int64_t map_index(const Topo &t, int l, const int64_t b[3]) {
  const int64_t nx = t.bpd[0] << l, ny = t.bpd[1] << l, nz = t.bpd[2] << l;
  (void)nx;
  return t.lvl_off[l] + (b[0] * ny + b[1]) * nz + b[2];
}

inline int32_t slot_of(const Topo &t, int l, const int64_t b[3]) {
  return t.slot_flat[map_index(t, l, b)];
}

inline bool internal_at(const Topo &t, int l, const int64_t b[3]) {
  return t.int_flat[map_index(t, l, b)] != 0;
}

// wrap/clamp a level-l cell coordinate; accumulate per-component signs.
// Returns false only on internal error (never expected).
inline void domainize(const Topo &t, int l, int64_t cell[3], float sign[3]) {
  for (int a = 0; a < 3; ++a) {
    const int64_t n = t.bpd[a] * (int64_t)t.bs << l;
    int64_t c = cell[a];
    if (t.bc[a] == 0) { // periodic
      c %= n;
      if (c < 0)
        c += n;
    } else {
      const bool out = (c < 0) || (c >= n);
      if (c < 0)
        c = 0;
      if (c >= n)
        c = n - 1;
      if (out) {
        if (t.bc[a] == 1) { // wall: every component flips
          sign[0] = -sign[0];
          sign[1] = -sign[1];
          sign[2] = -sign[2];
        } else { // freespace: only the face-normal component
          sign[a] = -sign[a];
        }
      }
    }
    cell[a] = c;
  }
}

// owner level of a level-l block position: l-1, l, or l+1 (-9 on error)
inline int owner_level(const Topo &t, int l, const int64_t b[3]) {
  if (slot_of(t, l, b) >= 0)
    return l;
  if (l > 0) {
    const int64_t p[3] = {b[0] >> 1, b[1] >> 1, b[2] >> 1};
    if (slot_of(t, l - 1, p) >= 0)
      return l - 1;
  }
  if (internal_at(t, l, b))
    return l + 1;
  return -9;
}

inline int64_t flat_idx(const Topo &t, int l, const int64_t cell[3]) {
  const int bs = t.bs;
  const int64_t b[3] = {cell[0] / bs, cell[1] / bs, cell[2] / bs};
  const int32_t slot = slot_of(t, l, b);
  if (slot < 0)
    return t.sentinel;
  const int64_t lx = cell[0] - b[0] * bs, ly = cell[1] - b[1] * bs,
                lz = cell[2] - b[2] * bs;
  return (int64_t)slot * bs * bs * bs + lx * bs * bs + ly * bs + lz;
}

} // namespace

extern "C" int cup3d_build_lab_tables(
    // topology
    int nb, int bs, int w, int level_max, const int64_t *bpd,
    const int32_t *bc, const int32_t *levels, const int64_t *ijk,
    const int32_t *slot_flat, const uint8_t *int_flat, const int64_t *lvl_off,
    // ghost coordinate list (ng entries of x,y,z in lab coords)
    int ng, const int64_t *gxyz,
    // outputs: fine path
    int64_t *g_idx,   // [nb*ng*8]
    float *g_w,       // [nb*ng*8]
    float *g_sign,    // [nb*ng*3]
    uint8_t *mask_co, // [nb*ng]
    // outputs: coarse scratch (S = cbs + 2*cw per axis)
    int cw, int64_t *s_idx, float *s_w, float *s_sign,
    // out flag: any block has a coarser neighbor
    int32_t *any_coarse) {
  Topo t{nb,     bs,       w,        level_max, bpd,
         bc,     levels,   ijk,      slot_flat, int_flat,
         lvl_off, (int64_t)nb * bs * bs * bs};
  const int cbs = bs / 2;
  const int S = cbs + 2 * cw;
  const int64_t ns = (int64_t)S * S * S;
  *any_coarse = 0;

  // initialize outputs to the same defaults as the numpy builder
  for (int64_t i = 0; i < (int64_t)nb * ng * 8; ++i) {
    g_idx[i] = t.sentinel;
    g_w[i] = 0.0f;
  }
  for (int64_t i = 0; i < (int64_t)nb * ng * 3; ++i)
    g_sign[i] = 1.0f;
  std::memset(mask_co, 0, (size_t)nb * ng);
  for (int64_t i = 0; i < (int64_t)nb * ns * 8; ++i) {
    s_idx[i] = t.sentinel;
    s_w[i] = 0.0f;
  }
  for (int64_t i = 0; i < (int64_t)nb * ns * 3; ++i)
    s_sign[i] = 1.0f;

  // pass 1: fine-path tables; record which LEVELS have any coarser
  // neighbor (the numpy builder fills the coarse scratch for every block
  // of such a level, so bit-parity requires the same granularity)
  bool level_any_coarser[64] = {false};
  for (int b = 0; b < nb; ++b) {
    const int l = levels[b];
    const int64_t bi = ijk[b * 3 + 0], bj = ijk[b * 3 + 1],
                  bk = ijk[b * 3 + 2];
    bool block_has_coarser = false;

    // ---- fine path: ghosts at the block's own level -------------------
    for (int gidx = 0; gidx < ng; ++gidx) {
      int64_t cell[3] = {bi * bs + (gxyz[gidx * 3 + 0] - w),
                         bj * bs + (gxyz[gidx * 3 + 1] - w),
                         bk * bs + (gxyz[gidx * 3 + 2] - w)};
      float sign[3] = {1.f, 1.f, 1.f};
      domainize(t, l, cell, sign);
      for (int a = 0; a < 3; ++a)
        g_sign[((int64_t)b * ng + gidx) * 3 + a] = sign[a];
      const int64_t bpos[3] = {cell[0] / bs, cell[1] / bs, cell[2] / bs};
      const int own = owner_level(t, l, bpos);
      if (own == -9)
        return 1; // unresolved owner: unbalanced tree
      int64_t *gi = g_idx + ((int64_t)b * ng + gidx) * 8;
      float *gw = g_w + ((int64_t)b * ng + gidx) * 8;
      if (own == l) {
        gi[0] = flat_idx(t, l, cell);
        gw[0] = 1.0f;
      } else if (own == l + 1) {
        int q = 0;
        for (int di = 0; di < 2; ++di)
          for (int dj = 0; dj < 2; ++dj)
            for (int dk = 0; dk < 2; ++dk, ++q) {
              const int64_t fine[3] = {2 * cell[0] + di, 2 * cell[1] + dj,
                                       2 * cell[2] + dk};
              gi[q] = flat_idx(t, l + 1, fine);
              gw[q] = 0.125f;
            }
      } else { // coarser
        mask_co[(int64_t)b * ng + gidx] = 1;
        block_has_coarser = true;
      }
    }
    if (block_has_coarser && l > 0)
      level_any_coarser[l] = true;
  }

  // pass 2: coarse scratch at level l-1
  for (int b = 0; b < nb; ++b) {
    const int l = levels[b];
    const int64_t bi = ijk[b * 3 + 0], bj = ijk[b * 3 + 1],
                  bk = ijk[b * 3 + 2];
    if (l == 0 || !level_any_coarser[l])
      continue;
    *any_coarse = 1;
    int64_t sidx = 0;
    for (int sx = 0; sx < S; ++sx)
      for (int sy = 0; sy < S; ++sy)
        for (int sz = 0; sz < S; ++sz, ++sidx) {
          int64_t ccell[3] = {bi * cbs + (sx - cw), bj * cbs + (sy - cw),
                              bk * cbs + (sz - cw)};
          float csign[3] = {1.f, 1.f, 1.f};
          domainize(t, l - 1, ccell, csign);
          for (int a = 0; a < 3; ++a)
            s_sign[((int64_t)b * ns + sidx) * 3 + a] = csign[a];
          const int64_t cb[3] = {ccell[0] / bs, ccell[1] / bs, ccell[2] / bs};
          const int cown = owner_level(t, l - 1, cb);
          if (cown == -9)
            return 1;
          int64_t *si = s_idx + ((int64_t)b * ns + sidx) * 8;
          float *sw = s_w + ((int64_t)b * ns + sidx) * 8;
          if (cown == l - 1) { // copy from the coarse leaf
            si[0] = flat_idx(t, l - 1, ccell);
            sw[0] = 1.0f;
          } else if (cown == l) { // average down 2^3 level-l cells
            int q = 0;
            for (int di = 0; di < 2; ++di)
              for (int dj = 0; dj < 2; ++dj)
                for (int dk = 0; dk < 2; ++dk, ++q) {
                  int64_t fine[3] = {2 * ccell[0] + di, 2 * ccell[1] + dj,
                                     2 * ccell[2] + dk};
                  const int64_t fb[3] = {fine[0] / bs, fine[1] / bs,
                                         fine[2] / bs};
                  const int fown = owner_level(t, l, fb);
                  if (fown == -9)
                    return 1;
                  if (fown == l + 1) {
                    // region two levels finer than the scratch: middle
                    // octant approximation (grid/blocks.py module doc)
                    const int64_t deep[3] = {2 * fine[0] + 1, 2 * fine[1] + 1,
                                             2 * fine[2] + 1};
                    si[q] = flat_idx(t, l + 1, deep);
                  } else {
                    si[q] = flat_idx(t, l, fine);
                  }
                  sw[q] = 0.125f;
                }
          } else if (cown == l - 2) { // far corner: constant injection
            const int64_t cc[3] = {ccell[0] >> 1, ccell[1] >> 1,
                                   ccell[2] >> 1};
            si[0] = flat_idx(t, l - 2, cc);
            sw[0] = 1.0f;
          }
        }
  }
  return 0;
}

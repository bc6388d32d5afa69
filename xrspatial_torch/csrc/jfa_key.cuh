// Per-candidate device code of the jump flood: the comparison keys of the
// two state forms and the candidate step built on them (key_of, adopt),
// shared by every route of jfa_round (jfa.cu) and of jfa_group
// (jfa_group.cu), so all of them compare candidates with the same
// instructions and choose the same targets bit for bit.
//
// Keys are written with __fmul_rn/__fadd_rn/__fsub_rn so that nvcc cannot
// contract dx*dx + dy*dy into an fma: the keys then equal the torch twins'
// separately rounded multiply and add (xrspatial_torch/kernels/
// jfa_rounds.py) bit for bit, and so does every choice between near-equal
// candidates.  The great-circle key calls libdevice sinf/cosf in place of
// the polynomials of xrspatial_tpu/kernels/pallas_jfa.py, which exist only
// because the TPU compiler builds trig slowly.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace xrt {

constexpr int kEuclidean = 0, kGreatCircle = 1, kManhattan = 2;
constexpr int kPackBits = 15, kPackMask = (1 << kPackBits) - 1;
// float32 pi/180, as the twin's scalar rounds to
constexpr float kDeg2Rad = 0.017453292519943295f;

// Key of the packed candidate `cand` (iy<<15|ix, -1 for none) seen from
// the cell (piy, pix); inf for -1.
template <int METRIC>
__device__ __forceinline__ float key_packed(int piy, int pix, int cand,
                                            float step_y, float step_x) {
  if (cand < 0) return CUDART_INF_F;
  const int ciy = cand >> kPackBits;  // arithmetic shift of a signed int
  const int cix = cand & kPackMask;
  const float dy = __fmul_rn((float)(piy - ciy), step_y);
  const float dx = __fmul_rn((float)(pix - cix), step_x);
  if (METRIC == kManhattan) return __fadd_rn(fabsf(dx), fabsf(dy));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Key of the target (tx, ty) seen from the cell at (px, py); inf where tx
// is not finite (no target).
template <int METRIC>
__device__ __forceinline__ float key_coords(float px, float py, float tx,
                                            float ty) {
  if (!isfinite(tx)) return CUDART_INF_F;
  if (METRIC == kGreatCircle) {
    // degrees-first deltas, as xrspatial_tpu/kernels/jfa.py::_metric_key
    if (px == tx && py == ty) return 0.0f;
    const float dlat_h = __fmul_rn(__fmul_rn(__fsub_rn(ty, py), kDeg2Rad),
                                   0.5f);
    const float dlon_h = __fmul_rn(__fmul_rn(__fsub_rn(tx, px), kDeg2Rad),
                                   0.5f);
    const float slat = sinf(dlat_h);
    const float slon = sinf(dlon_h);
    const float c12 = __fmul_rn(cosf(__fmul_rn(py, kDeg2Rad)),
                                cosf(__fmul_rn(ty, kDeg2Rad)));
    return __fadd_rn(__fmul_rn(slat, slat),
                     __fmul_rn(c12, __fmul_rn(slon, slon)));
  }
  const float dx = __fsub_rn(px, tx);
  const float dy = __fsub_rn(py, ty);
  if (METRIC == kManhattan) return __fadd_rn(fabsf(dx), fabsf(dy));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The state forms of the staged, vector and single-buffered routes, which
// hold every plane as 32-bit words: packed (one int32 plane, iy<<15|ix)
// and coordinates (two float32 planes, tx and ty, as their bits).
constexpr int kPacked = 0, kCoords = 1;
constexpr int kInfBits = 0x7f800000;  // +inf as a float32's bits

template <int FORM>
struct StateForm {
  static constexpr int kPlanes = FORM == kPacked ? 1 : 2;
  // plane 0's no-target sentinel; plane 1 (ty) takes kInfBits
  static constexpr int kSentinel = FORM == kPacked ? -1 : kInfBits;
};

// Where a cell stands, for its keys: raster indices (packed) or world
// coordinates (coordinates).
struct Pos {
  int iy, ix;
  float px, py;
};

// Key of the candidate whose words are (a, b) (b unused when packed),
// seen from `p`.
template <int FORM, int METRIC>
__device__ __forceinline__ float key_of(const Pos& p, int a, int b,
                                        float step_y, float step_x) {
  if (FORM == kPacked) return key_packed<METRIC>(p.iy, p.ix, a, step_y,
                                                 step_x);
  return key_coords<METRIC>(p.px, p.py, __int_as_float(a),
                            __int_as_float(b));
}

// One candidate of a cell: adopts (a, b) when its key is strictly smaller
// than `best`, and says whether it did.  Calling it over the candidates in
// (sy, sx) row-major order from the cell's own target is a round.
template <int FORM, int METRIC>
__device__ __forceinline__ bool adopt(const Pos& p, float step_y,
                                      float step_x, int a, int b,
                                      float& best, int& s0, int& s1) {
  const float nd = key_of<FORM, METRIC>(p, a, b, step_y, step_x);
  const bool better = nd < best;
  if (better) {
    best = nd;
    s0 = a;
    s1 = b;
  }
  return better;
}

}  // namespace xrt

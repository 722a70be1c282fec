// A 64 x 64 product through the tile helpers of common.cuh alone, for the
// card test that holds them against torch.matmul before any kernel is
// trusted with them: cp.async into swizzled tiles, A fragments by ldmatrix
// or through a descriptor, B through a wgmma descriptor in both
// orientations, the 32-byte swizzled 64 x 16 tiles of the forward at
// kD = 80, and the int8 tiles of the int8 kernel through its s8 wgmma. A wrong descriptor gives plausible numbers, not a fault, so it is
// tested apart. It replaces no TPU kernel and runs on no path of the port.

#include "common.cuh"

namespace {

// bf16 modes: a [64, 64] bf16 row-major; b [64, 64] bf16 row-major, of
// which only the first ``rows`` rows are read (the rest count as zeros);
// c [64, 64] f32. mode 0: c = a b^T, a as register fragments (b's rows are
// the product's columns, K-major). mode 1: c = a b (b's rows are the k
// index, MN-major). mode 2: c = a b^T with a read from shared memory
// through a descriptor.
// int8 modes (the int8 kernel's tiles and wgmma): a [64, 128] int8, b
// [64, 128] int8 of which the first ``rows`` rows are read, c [64, 64]
// int32 = a b^T. B's tile has 128 rows (m64n128k32), those past ``rows``
// zero-filled; c holds its first 64 columns. mode 3: k = 128; mode 4: only
// the first 64 bytes of each row (a half k tile: the rest zero-filled and
// its k-steps not issued).
// 16-wide bf16 modes (the forward at kD = 80), c f32. mode 5: c [64, 64] =
// a b^T with a and b [64, 16] bf16 row-major, both 32-byte swizzled 64 x 16
// tiles read through descriptors (K-major), the first ``rows`` rows of b
// read. mode 6: c [64, 16] = a b with a [64, 64] bf16 as register
// fragments and b [64, 16] bf16 a 64 x 16 tile whose rows are the k index
// (MN-major, the transposed-B form), only the k-steps that reach one of its
// first ``rows`` rows. mode 7: mode 1's c = a b with a's fragments first
// stored into a third tile by store_a_swizzled and read back by
// load_a_swizzled (the wide attention backward's P and dS hand-over).
__global__ void __launch_bounds__(128)
tile_mma_selftest(const void* __restrict__ a, const void* __restrict__ b,
                  void* __restrict__ c, int mode, int rows) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = cxr::smem_addr(smem_raw);
  const uint32_t ta = (raw + 1023u) & ~1023u, tb = ta + cxr::kTileBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if (mode == 3 || mode == 4) {
    const int kbytes = mode == 3 ? 128 : 64;
    cxr::copy_s8_tile_async<64, 128>(ta, static_cast<const int8_t*>(a), 128,
                                     64, kbytes);
    cxr::copy_s8_tile_async<128, 128>(tb, static_cast<const int8_t*>(b), 128,
                                      rows, kbytes);
    cxr::cp_async_commit();
    cxr::cp_async_wait<0>();
    __syncthreads();
    int acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
    cxr::acc_fence(acc);
    cxr::wgmma_fence();
    cxr::tile_mma_s8(acc, ta, tb, kbytes / 32);
    cxr::wgmma_commit();
    cxr::wgmma_wait<0>(acc);
    int* ci = static_cast<int*>(c);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ci[(warp * 16 + g + 8 * (e >> 1)) * 64 + n * 8 + 2 * t + (e & 1)] =
            acc[n][e];
    return;
  }

  const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b);
  if (mode == 5)
    cxr::copy_tile16_async(ta, ab, 16, 0, 64, 0, 16);
  else
    cxr::copy_tile_async(ta, ab, 64, 0, 64);
  if (mode == 5 || mode == 6)
    cxr::copy_tile16_async(tb, bb, 16, 0, rows, 0, 16);
  else
    cxr::copy_tile_async(tb, bb, 64, 0, rows);
  cxr::cp_async_commit();
  cxr::cp_async_wait<0>();
  __syncthreads();

  uint32_t af[4][4];
  cxr::load_a_swizzled(ta, warp * 16, lane, af);
  if (mode == 7) {
    const uint32_t tc = tb + cxr::kTileBytes;
    cxr::store_a_swizzled(smem_raw + (tc - raw), warp * 16, lane, af);
    __syncthreads();
    cxr::load_a_swizzled(tc, warp * 16, lane, af);
  }
  float* cf = static_cast<float*>(c);
  if (mode == 6) {
    float acc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    cxr::acc_fence(acc);
    cxr::wgmma_fence(af);
    cxr::tile16_mma_rs(acc, af, tb, rows);
    cxr::wgmma_commit();
    cxr::wgmma_wait<0>(acc);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cf[(warp * 16 + g + 8 * (e >> 1)) * 16 + n * 8 + 2 * t + (e & 1)] =
            acc[n][e];
    return;
  }
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  cxr::acc_fence(acc);
  cxr::wgmma_fence(af);
  if (mode == 1 || mode == 7)
    cxr::tile_mma_rs<true>(acc, af, tb, rows);
  else if (mode == 0)
    cxr::tile_mma_rs<false>(acc, af, tb);
  else if (mode == 2)
    cxr::tile_mma_ss(acc, ta, tb);
  else
    cxr::tile16_mma_ss(acc, ta, tb);
  cxr::wgmma_commit();
  cxr::wgmma_wait<0>(acc);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cf[(warp * 16 + g + 8 * (e >> 1)) * 64 + n * 8 + 2 * t + (e & 1)] =
          acc[n][e];
}

}  // namespace

extern "C" int cxr_tile_mma_selftest(const void* a, const void* b, void* c,
                                     int mode, int rows, int device,
                                     void* stream) {
  if (rows < 1 || rows > 64 || mode < 0 || mode > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // bf16: two tiles (64 x 64 or 64 x 16), a third in mode 7; int8: a
  // 64-row and a 128-row tile
  tile_mma_selftest<<<1, 128, 3 * cxr::kTileBytes + 1024,
                      static_cast<cudaStream_t>(stream)>>>(a, b, c, mode,
                                                           rows);
  return static_cast<int>(cudaGetLastError());
}

// The bilinear transform and the even/odd f64 class sums of a step, one
// hand-written CUDA kernel for Hopper (sm_90a), with a small second pass.
//
// Replaces no TPU kernel: the JAX package's gather step transforms and sums
// with XLA ops (cryo_ralib_tpu/ops/transform.py::transform_batch,
// cryo_ralib_tpu/ops/classavg.py::class_sum_oe).  It is the port's
// counterpart of the original's cu_transform_batch + cu_average_batch_m
// (SURVEY.md section 2.1, K4 and K6), and computes what the plain PyTorch
// route ops/classavg.py::class_sums_plain computes: every particle
// transformed by its params as ops/transform.py::transform_batch does, and
// added into the f64 sum of its slot, ref_id * 2 + (global index & 1), with
// the per-class counts.  The transformed image is never written.
//
// The samples.  Per target pixel (x, y) of particle p: ux = (mirror ? w - x
// : x) - w/2, uy = y - h/2 (exact small integers), rx = ux*c - uy*s + w/2 +
// shift_x, ry = ux*s + uy*c + h/2 + shift_y with c, s the f32 cos and sin
// the wrapper computed by transform_batch's own torch ops; then
// bilinear_sample's clamp to the edge, floor, and v00*(1-fx) + v01*fx, ...
// Every f32 operation is written with __fmul_rn / __fadd_rn / __fsub_rn, in
// transform_batch's order, so nothing is contracted into an FMA and each
// sample equals transform_batch's bit for bit.
//
// The sums.  Each sample is converted to f64 (exactly) and added in an order
// fixed by the inputs alone, with no float atomics: the wrapper sorts the
// particles by slot (a stable sort on the card, dropped particles last) and
// cuts each slot's run into chunks of `chunk` particles; block b of pass 1
// takes one chunk, walks its particles in sorted order and keeps each of
// its pixels' f64 sum in a register, then writes the chunk's partial image;
// pass 2 adds each slot's partials in chunk order.  Repeated calls are bit
// identical, and the sums equal class_sum_oe's to f64 rounding.
//
// What bounds it on the H100: one read of the stack, N*H*W*4 bytes at 3.35
// TB/s (1.02 ms for 105,247 particles of 90 px).  The arithmetic is ~40
// instructions a pixel (coordinates, four gathers, the lerps, one f64 add),
// 852 M pixels there, about a millisecond of the SMs' issue rate; the
// partials add N*H*W/chunk f64 writes and reads (1/(2*chunk) of the stack's
// bytes).
//
// What the design does about it.  The stack is read once, in slot order,
// each image by one block (by one block a tile where a box takes several).
// The four gathers of a sample land where the rotation puts them: a warp's
// 32 pixels of one row fall on up to 32 rows of the source, so through L1
// a gather costs about one wavefront per cache line it touches.  So a block
// copies each image into shared memory first (two buffers, cp.async, 16 B a
// copy where the box allows), the next particle's copy in flight while it
// samples this one, and a gather costs its bank conflicts alone: at 90 px,
// 3.01 ms against 4.36 ms through L1 for 105,247 particles (H100 SXM, 700 W).
// Where two buffers exceed STAGE_BYTES (boxes over 118 px) the image is
// read through the cache, with the next particle's lines prefetched into L2
// (at 90 px, in a first design of 256 threads x 32 pixels, 7.28 against
// 8.59 ms without the prefetch): at 120 px the two ran alike, at 160 px
// staging, one block a SM, was 15% slower.  A thread holds PIX pixels of
// a tile of THREADS * PIX (a 90 px box is one tile; a larger
// box takes several, the grid's second axis), their f64 sums in registers
// (64 registers, two blocks of 512 threads a SM) and their coordinates
// packed in one register each.  The grid is sized from shapes alone,
// ceil(N/chunk) + 2K blocks, the most that any split of N particles into 2K
// slots needs: blocks past the plan's chunks exit at once, so no count is
// read back to the host.  chunk = 64 (ops/classavg.py::SUM_CHUNK) measured
// best of 32, 64 and 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;          // threads per block of pass 1
constexpr int PIX = 16;               // pixels per thread in one tile
constexpr int TILE = THREADS * PIX;   // pixels per block
// the most shared memory a block stages images in: two blocks a SM
constexpr size_t STAGE_BYTES = 110 * 1024;
constexpr int REDUCE_THREADS = 256;   // threads per block of pass 2

// transform_batch's sample of `img` at target pixel (x, y), for a particle
// with cos c, sin s, shift (sx, sy) and mirror flag m; `img` is the block's
// copy in shared memory (STAGED) or the stack's, read through the cache
template <bool STAGED>
__device__ __forceinline__ float sample(const float* __restrict__ img, int x,
                                        int y, int h, int w, float c, float s,
                                        float sx, float sy, bool m) {
  const float ux = (float)((m ? w - x : x) - w / 2);
  const float uy = (float)(y - h / 2);
  float rx = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ux, c), __fmul_rn(uy, s)),
                                 (float)(w / 2)),
                       sx);
  float ry = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ux, s), __fmul_rn(uy, c)),
                                 (float)(h / 2)),
                       sy);
  rx = fminf(fmaxf(rx, 0.0f), (float)(w - 1));
  ry = fminf(fmaxf(ry, 0.0f), (float)(h - 1));
  const float x0 = floorf(rx), y0 = floorf(ry);
  const int ix0 = (int)x0, iy0 = (int)y0;
  const int ix1 = min(ix0 + 1, w - 1), iy1 = min(iy0 + 1, h - 1);
  const float fx = __fsub_rn(rx, x0), fy = __fsub_rn(ry, y0);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const int i00 = iy0 * w + ix0, i01 = iy0 * w + ix1;
  const int i10 = iy1 * w + ix0, i11 = iy1 * w + ix1;
  const float v00 = STAGED ? img[i00] : __ldg(img + i00);
  const float v01 = STAGED ? img[i01] : __ldg(img + i01);
  const float v10 = STAGED ? img[i10] : __ldg(img + i10);
  const float v11 = STAGED ? img[i11] : __ldg(img + i11);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// Copy one image (hw floats) into shared memory `dst` with cp.async, 16 B a
// copy where `vec` (hw a multiple of 4 and the stack 16-byte aligned), else
// 4 B; the block's threads share the copies; one commit group.
__device__ __forceinline__ void stage_image(float* dst, const float* src,
                                            int hw, bool vec) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec) {
    for (int o = 4 * threadIdx.x; o < hw; o += 4 * THREADS)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 4 * o),
                   "l"(src + o));
  } else {
    for (int o = threadIdx.x; o < hw; o += THREADS)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       base + 4 * o),
                   "l"(src + o));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Pass 1: block (b, tile) sums chunk b's particles over its tile of pixels
// into partial[b][pixel].  STAGED: each image is copied into one of two
// shared-memory buffers while the block samples the other.
template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 2)
chunk_sums_kernel(const float* __restrict__ images,
                  const int* __restrict__ order,
                  const float* __restrict__ cosv,
                  const float* __restrict__ sinv,
                  const float* __restrict__ shx,
                  const float* __restrict__ shy,
                  const int* __restrict__ mirror,
                  const int* __restrict__ slot_start,
                  const int* __restrict__ chunk_start, int n_slots,
                  int chunk, int h, int w, double* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  if (b >= chunk_start[n_slots]) return;      // past the plan's chunks
  // the slot whose chunks hold b: chunk_start[lo] <= b < chunk_start[lo + 1]
  int lo = 0, hi = n_slots;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= b) lo = mid; else hi = mid;
  }
  const int first = slot_start[lo] + (b - chunk_start[lo]) * chunk;
  const int last = min(first + chunk, slot_start[lo + 1]);
  const int hw = h * w;
  const int hw4 = (hw + 3) & ~3;              // a buffer's stride
  const bool vec = (hw & 3) == 0 && ((uintptr_t)images & 15) == 0;
  float* buf = reinterpret_cast<float*>(smem4);
  const int pix0 = blockIdx.y * TILE + threadIdx.x;

  double acc[PIX];
  uint32_t xy[PIX];     // x | y << 16 of each pixel
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    acc[j] = 0.0;
    const int pix = pix0 + THREADS * j;
    const int y = pix / w;
    xy[j] = (uint32_t)(pix - y * w) | ((uint32_t)y << 16);
  }
  if (STAGED)
    stage_image(buf, images + (size_t)__ldg(order + first) * hw, hw, vec);
  for (int i = first; i < last; ++i) {
    const int p = __ldg(order + i);
    const float* img = images + (size_t)p * hw;
    if (i + 1 < last) {
      const float* next = images + (size_t)__ldg(order + i + 1) * hw;
      if (STAGED) {
        stage_image(buf + ((i + 1 - first) & 1) * hw4, next, hw, vec);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        // the next particle's lines into L2 while this one is sampled
        for (int o = threadIdx.x * 32; o < hw; o += THREADS * 32)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(next + o));
      }
    } else if (STAGED) {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    if (STAGED) {
      __syncthreads();                        // particle i is in its buffer
      img = buf + ((i - first) & 1) * hw4;
    }
    const float c = __ldg(cosv + p), s = __ldg(sinv + p);
    const float sx = __ldg(shx + p), sy = __ldg(shy + p);
    const bool m = __ldg(mirror + p) == 1;
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      if (pix0 + THREADS * j < hw)
        acc[j] += (double)sample<STAGED>(img, (int)(xy[j] & 0xffffu),
                                         (int)(xy[j] >> 16), h, w, c, s, sx,
                                         sy, m);
    }
    if (STAGED) __syncthreads();              // its buffer may be refilled
  }
  double* out = partial + (size_t)b * hw;
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int pix = pix0 + THREADS * j;
    if (pix < hw) out[pix] = acc[j];
  }
}

// Pass 2: sums[slot][pixel] = the slot's partials added in chunk order
// (0 for a slot with no particle).
__global__ void slot_sums_kernel(const double* __restrict__ partial,
                                 const int* __restrict__ chunk_start, int hw,
                                 double* __restrict__ sums) {
  const int slot = blockIdx.x;
  const int pix = blockIdx.y * REDUCE_THREADS + threadIdx.x;
  if (pix >= hw) return;
  double acc = 0.0;
  for (int b = chunk_start[slot]; b < chunk_start[slot + 1]; ++b)
    acc += partial[(size_t)b * hw + pix];
  sums[(size_t)slot * hw + pix] = acc;
}

// Shared memory of a staged block: two buffers of hw floats, rounded up to
// 16 B; 0 where that exceeds STAGE_BYTES (the image is then read
// through the cache)
size_t stage_bytes(int h, int w) {
  const size_t bytes = 2 * 4 * (((size_t)h * w + 3) & ~(size_t)3);
  return bytes <= STAGE_BYTES ? bytes : 0;
}

}  // namespace

extern "C" {

// Shared memory per block of pass 1 at an h x w box (0: not staged).
long long cryo_class_sums_smem(int h, int w) { return (long long)stage_bytes(h, w); }

// Launch both passes on `stream`.  `order` (N,) holds the particles' indices
// sorted by slot, `slot_start` and `chunk_start` (n_slots + 1,) each slot's
// first position in `order` and first chunk (ops/classavg.py::sum_plan);
// `partial` holds n_blocks * h * w f64, `sums` n_slots * h * w.  Returns the
// cudaError_t of the launches (0 = success).
int cryo_class_sums_launch(const float* images, const int* order,
                           const float* cosv, const float* sinv,
                           const float* shx, const float* shy,
                           const int* mirror, const int* slot_start,
                           const int* chunk_start, int n_slots, int chunk,
                           int n_blocks, int h, int w, double* partial,
                           double* sums, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int hw = h * w;
  if (n_slots < 1 || chunk < 1 || n_blocks < 1 || h < 1 || w < 1
      || h >= 65536 || w >= 65536)
    return (int)cudaErrorInvalidValue;
  const dim3 grid1(n_blocks, (hw + TILE - 1) / TILE);
  const size_t smem = stage_bytes(h, w);
  cudaError_t err;
  if (smem) {
    err = cudaFuncSetAttribute(chunk_sums_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    chunk_sums_kernel<true><<<grid1, THREADS, smem, st>>>(
        images, order, cosv, sinv, shx, shy, mirror, slot_start, chunk_start,
        n_slots, chunk, h, w, partial);
  } else {
    chunk_sums_kernel<false><<<grid1, THREADS, 0, st>>>(
        images, order, cosv, sinv, shx, shy, mirror, slot_start, chunk_start,
        n_slots, chunk, h, w, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(n_slots, (hw + REDUCE_THREADS - 1) / REDUCE_THREADS);
  slot_sums_kernel<<<grid2, REDUCE_THREADS, 0, st>>>(partial, chunk_start,
                                                        hw, sums);
  return (int)cudaGetLastError();
}

const char* cryo_class_sums_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Rotational + translational + mirror alignment search, one hand-written
// CUDA kernel for Hopper (sm_90a).
//
// Replaces cryo_ralib_tpu/ops/fused_search.py::_kernel_banded2 (the Pallas
// TPU kernel, :129, launched through pl.pallas_call at :512).  It computes
// what the f32 plain search cryo_ralib_tpu_torch/ops/search.py::
// rotational_shift_search computes, per particle:
//   for every grid shift s (S of them):
//     1. bilinear clamp-to-edge polar samples, R rings x 256 angles, at
//        x = cx + (acc_x + grid_x) + px  (the plain version's f32 operations
//        in its order, with no FMA contraction);
//     2. the 256-point real DFT of each ring (bins 0..128);
//     3. the ring-weighted ccf against all K refs: orig = sum_r conj(S) R,
//        mirr = conj(sum_r S R) (weights are folded into ref_fw);
//     4. the inverse DFT to 256-angle rows (normalised by 1/256);
//     5. the argmax in the flat priority order (mirror, shift, ref, angle):
//        a candidate wins on a larger value, or on an equal value with a
//        lower priority e = ((m*S + s)*K + k)*256 + a.  Mirror is the
//        outermost axis although the loop runs shifts outermost, so the tie
//        rule compares e rather than relying on loop order.
//   Outputs: peak value, winning 256-angle row, angle bin, shift index,
//   ref and mirror flag.
//
// Variants: search_kernel<NMIRR, MASK, KG>, eight instantiations picked at
// launch (cryo_search_launch); each is one static variant of the TPU body:
//   NMIRR=2, MASK=false  the default variant (mirrored, unmasked, full
//                        stage; fused_search.py:129).
//   NMIRR=1              do_mirror=False, --nomirror (fused_search.py:147-152,
//                        :181-183, :289-291, :505-507): the ccf builds and the
//                        inverse DFT inverts the original channel only, so
//                        half the ccf stores and inverse-DFT rows; m stays 0
//                        in e, so ties still break by (shift, ref, angle).
//   MASK=true            has_mask=True, --dst (fused_search.py:162-167,
//                        :389-394, :439-443, :533-535): thread t adds
//                        mask[t] (0 on allowed bins, -3e38 elsewhere) to the
//                        value it offers for angle t before the argmax.  The
//                        reported peak is the masked value (equal to the
//                        unmasked one on an allowed bin, where the mask is
//                        exactly 0); the winning row stays unmasked, as the
//                        TPU kernel keeps it.  A masked candidate rounds to
//                        exactly -3e38 and may tie the initial best and take
//                        it on its lower e, but any allowed candidate beats
//                        it, so while one bin is allowed (the wrapper
//                        checks) the winner is allowed.
//   KG=1 or 8            the refs per ccf / inverse-DFT group: 1 when K=1
//                        (the reference-free driver), else 8.  Large K
//                        (fold=True and the ref-axis chunks of
//                        fused_search.py:356-424, :752-781, _merge_chunk
//                        :791) needs no variant: the ref-group loop covers any
//                        K in one launch with the same priority rule.
// The ablation stages (stage in {no_ccf, no_yred, sample_only}, :329-348)
// are a TPU measurement harness and are not ported; raw4 (:174-176) is a
// TPU accumulator layout with the default variant's outputs.
//
// What bounds it on the H100.  Per particle at the headline geometry
// (R=36, K=8, S=49): the ring DFT is S*R*256*256 ~ 116 M real MACs, the
// ccf 4*K*S*R*129 ~ 7.3 M MACs and the inverse DFT 2*K*S*256*129*2 ~ 52 M
// MACs, against a 32 KB image read.  So the direct DFTs dominate and the
// kernel is bound by f32 arithmetic (and the shared memory traffic that
// feeds it), not by device memory.  Measured on one H100 SXM at a 700 W
// limit: 274 ms per 16384-particle headline search, ~21 TFLOP/s of
// direct-DFT work, about a third of the f32 peak.
//
// What the design does about it.  One 256-thread block per particle loops
// over the shifts; nothing leaves the block but the winner, so device
// memory sees only the image, the ref spectra (L2-resident) and the
// outputs.  The DFT is a (R x 256) x (256 x 256) product, taken RG rings at
// a time: the block samples RG rings, then thread t computes one output
// column for them (cos bins 0..128 for t <= 128, -sin bins 1..127 above;
// the sin rows of bins 0 and 128 are zero) with RG accumulators in
// registers, reading each ring sample once per four angles as a float4
// broadcast and the twiddle from a 256-entry cos table in shared memory.
// The inverse DFT is the transpose: thread t owns angle t for NMIRR*KG
// rows.  A radix-2 FFT and tensor-core variants are later work.
//
// Shared memory per block: twiddles 1 KB, warp partials, one ring group of
// samples (RG x 256 floats, 12 KB), the ring spectra (R rounded up to RG,
// x 256 floats: 36 KB at R=36, 108 KB at R=100) and the ccf spectra of
// one ref group (NMIRR*KG*129 float2, 16.5 KB for the default variant):
// 67 KB at the headline, so three blocks fit on an SM.  The image is read
// through the read-only cache (__ldg), so any box size runs; only R bounds
// the shared memory (R <= 192 fits the 227 KB a block may take).

#include <cuda_runtime.h>

#define L 256
#define F 129
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define RG 12  // rings per register group of the forward DFT

__device__ __forceinline__ bool beats(float v, int e, float bv, int be) {
  return v > bv || (v == bv && e < be);
}

// Clamp-to-edge bilinear read, the operation order of ops/interp.py, with
// explicit round-to-nearest intrinsics so nvcc contracts nothing into FMAs.
__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                          int h, int w, float y, float x) {
  x = fminf(fmaxf(x, 0.f), (float)(w - 1));
  y = fminf(fmaxf(y, 0.f), (float)(h - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  const int ix0 = (int)x0, iy0 = (int)y0;
  const int ix1 = min(ix0 + 1, w - 1), iy1 = min(iy0 + 1, h - 1);
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float v00 = __ldg(img + iy0 * w + ix0);
  const float v01 = __ldg(img + iy0 * w + ix1);
  const float v10 = __ldg(img + iy1 * w + ix0);
  const float v11 = __ldg(img + iy1 * w + ix1);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

static inline int ring_pad(int n_rings) { return (n_rings + RG - 1) / RG * RG; }

static inline int ref_group(int n_refs) { return n_refs == 1 ? 1 : 8; }

static inline size_t smem_bytes(int n_rings, int n_mirr, int kg) {
  const size_t r_pad = (size_t)ring_pad(n_rings);
  return sizeof(float) * (L + 2 * NWARPS)      // twiddles, warp partials
         + sizeof(float) * RG * L              // one ring group of samples
         + sizeof(float) * r_pad * L           // ring spectra
         + sizeof(float2) * n_mirr * kg * F;   // ccf spectra of a ref group
}

template <int NMIRR, bool MASK, int KG>
__global__ void __launch_bounds__(NTHREADS)
search_kernel(const float* __restrict__ images,   // (N, H, W)
              const float* __restrict__ acc_sx,   // (N,) accumulated shifts
              const float* __restrict__ acc_sy,   // (N,)
              const float* __restrict__ coords,   // (R, L, 2) polar offsets
              const float* __restrict__ shifts,   // (S, 2) grid shifts
              const float2* __restrict__ ref_fw,  // (K, R, F) ref spectra
              const float* __restrict__ twiddle,  // (L,) cos(2 pi j / L)
              const float* __restrict__ mask,     // (L,) angle mask if MASK
              int h, int w, int n_rings, int n_shifts, int n_refs,
              float* __restrict__ out_val,        // (N,)
              float* __restrict__ out_row,        // (N, L)
              int* __restrict__ out_aidx, int* __restrict__ out_sidx,
              int* __restrict__ out_ref, int* __restrict__ out_mirror) {
  extern __shared__ __align__(16) float smem[];
  const int r_pad = (n_rings + RG - 1) / RG * RG;
  float* tw = smem;                                // L
  float* red_v = tw + L;                           // NWARPS
  int* red_e = (int*)(red_v + NWARPS);             // NWARPS
  float* polar = (float*)(red_e + NWARPS);         // RG * L
  float* spec = polar + RG * L;                    // r_pad * L
  float2* X = (float2*)(spec + r_pad * L);         // NMIRR * KG * F

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  tw[t] = twiddle[t];

  const float* img = images + (size_t)n * h * w;
  const float ax = acc_sx[n], ay = acc_sy[n];
  const float cx = (float)(w / 2), cy = (float)(h / 2);

  // forward-DFT column of this thread: cos bin t, or -sin bin t-128
  // (-sin(theta) = cos(theta + pi/2), a quarter turn = 64 table entries)
  const int f_col = (t <= 128) ? t : t - 128;
  const int off_col = (t <= 128) ? 0 : 64;
  const float mask_t = MASK ? mask[t] : 0.f;

  float best_v = -3.0e38f;  // identical in every thread
  int best_e = 0x7fffffff;
  float my_row = 0.f;       // this thread's angle of the winning row
  __syncthreads();

  for (int s = 0; s < n_shifts; ++s) {
    const float bx = __fadd_rn(cx, __fadd_rn(ax, shifts[2 * s]));
    const float by = __fadd_rn(cy, __fadd_rn(ay, shifts[2 * s + 1]));

    for (int rg = 0; rg < r_pad; rg += RG) {
      // 1. polar samples of rings rg .. rg+RG-1; padding rings are zero
      for (int q = t; q < RG * L; q += NTHREADS) {
        const int qg = rg * L + q;
        float v = 0.f;
        if (qg < n_rings * L) {
          const float x = __fadd_rn(bx, coords[2 * qg]);
          const float y = __fadd_rn(by, coords[2 * qg + 1]);
          v = bilinear(img, h, w, y, x);
        }
        polar[q] = v;
      }
      __syncthreads();

      // 2. their DFT, column t
      float acc[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] = 0.f;
      int idx = off_col;
      for (int j = 0; j < L; j += 4) {
        const float w0 = tw[idx & (L - 1)]; idx += f_col;
        const float w1 = tw[idx & (L - 1)]; idx += f_col;
        const float w2 = tw[idx & (L - 1)]; idx += f_col;
        const float w3 = tw[idx & (L - 1)]; idx += f_col;
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(polar + i * L + j);
          acc[i] = fmaf(p.x, w0, acc[i]);
          acc[i] = fmaf(p.y, w1, acc[i]);
          acc[i] = fmaf(p.z, w2, acc[i]);
          acc[i] = fmaf(p.w, w3, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RG; ++i) spec[(rg + i) * L + t] = acc[i];
      __syncthreads();  // the next group's samples overwrite `polar`
    }

    for (int k0 = 0; k0 < n_refs; k0 += KG) {
      const int kn = min(KG, n_refs - k0);

      // 3. ccf spectra of refs k0 .. k0+kn-1, pre-scaled for the inverse
      //    (x2 for the bins that stand for a conjugate pair, /L);
      //    the imaginary parts of bins 0 and 128 are dropped (C2R)
      for (int it = t; it < kn * F; it += NTHREADS) {
        const int kl = it / F, f = it - kl * F;
        const bool has_im = (f > 0 && f < L / 2);
        const float2* rp = ref_fw + (size_t)(k0 + kl) * n_rings * F + f;
        float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
        for (int r = 0; r < n_rings; ++r) {
          const float sr = spec[r * L + f];
          const float si = has_im ? spec[r * L + L / 2 + f] : 0.f;
          const float2 rr = __ldg(rp + (size_t)r * F);
          a = fmaf(sr, rr.x, a);
          b = fmaf(si, rr.y, b);
          c = fmaf(sr, rr.y, c);
          d = fmaf(si, rr.x, d);
        }
        const float scale = has_im ? (2.f / L) : (1.f / L);
        const float im_o = has_im ? (c - d) * scale : 0.f;
        const float im_m = has_im ? -(c + d) * scale : 0.f;
        X[kl * F + f] = make_float2((a + b) * scale, im_o);          // orig
        if (NMIRR == 2)
          X[(KG + kl) * F + f] = make_float2((a - b) * scale, im_m);  // mirr
      }
      __syncthreads();

      // 4. inverse DFT: thread t = angle t, rows g = m*KG + kl
      float racc[NMIRR * KG];
#pragma unroll
      for (int g = 0; g < NMIRR * KG; ++g) racc[g] = 0.f;
      int idx = 0;
      for (int f = 0; f < F; ++f) {
        const float cw = tw[idx & (L - 1)];          // cos(2 pi f t / L)
        const float sw = tw[(idx + 64) & (L - 1)];   // -sin(2 pi f t / L)
        idx += t;
#pragma unroll
        for (int g = 0; g < NMIRR * KG; ++g) {
          const float2 xv = X[g * F + f];
          racc[g] = fmaf(xv.x, cw, racc[g]);
          racc[g] = fmaf(xv.y, sw, racc[g]);
        }
      }

      // 5. priority argmax over this thread's rows (masked values under
      //    MASK), then the block
      float tv = -3.0e38f;
      int te = 0x7fffffff;
#pragma unroll
      for (int g = 0; g < NMIRR * KG; ++g) {
        const int m = g / KG, kl = g % KG;
        if (kl < kn) {
          const int e = ((m * n_shifts + s) * n_refs + k0 + kl) * L + t;
          const float v = MASK ? racc[g] + mask_t : racc[g];
          if (beats(v, e, tv, te)) { tv = v; te = e; }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, tv, off);
        const int oe = __shfl_down_sync(0xffffffffu, te, off);
        if (beats(ov, oe, tv, te)) { tv = ov; te = oe; }
      }
      if (lane == 0) { red_v[warp] = tv; red_e[warp] = te; }
      __syncthreads();
      float gv = red_v[0];
      int ge = red_e[0];
#pragma unroll
      for (int i = 1; i < NWARPS; ++i)
        if (beats(red_v[i], red_e[i], gv, ge)) { gv = red_v[i]; ge = red_e[i]; }
      if (beats(gv, ge, best_v, best_e)) {
        best_v = gv;
        best_e = ge;
        const int rest = ge / L;
        const int gw = (rest / n_refs / n_shifts) * KG + (rest % n_refs - k0);
#pragma unroll
        for (int g = 0; g < NMIRR * KG; ++g)
          if (g == gw) my_row = racc[g];   // unmasked
      }
      // the partials are rewritten only after the next group's ccf barrier
    }
  }

  out_row[(size_t)n * L + t] = my_row;
  if (t == 0) {
    const int rest = best_e / L;
    out_val[n] = best_v;
    out_aidx[n] = best_e % L;
    out_ref[n] = rest % n_refs;
    out_sidx[n] = (rest / n_refs) % n_shifts;
    out_mirror[n] = rest / n_refs / n_shifts;
  }
}

template <int NMIRR, bool MASK, int KG>
static cudaError_t launch(const float* images, const float* acc_sx,
                          const float* acc_sy, const float* coords,
                          const float* shifts, const float* ref_fw,
                          const float* twiddle, const float* mask, int n,
                          int h, int w, int n_rings, int n_shifts, int n_refs,
                          float* out_val, float* out_row, int* out_aidx,
                          int* out_sidx, int* out_ref, int* out_mirror,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(n_rings, NMIRR, KG);
  cudaError_t err = cudaFuncSetAttribute(
      search_kernel<NMIRR, MASK, KG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  search_kernel<NMIRR, MASK, KG><<<n, NTHREADS, smem, stream>>>(
      images, acc_sx, acc_sy, coords, shifts, (const float2*)ref_fw, twiddle,
      mask, h, w, n_rings, n_shifts, n_refs, out_val, out_row, out_aidx,
      out_sidx, out_ref, out_mirror);
  return cudaGetLastError();
}

template <int NMIRR, bool MASK>
static cudaError_t launch_kg(int n_refs, const float* images,
                             const float* acc_sx, const float* acc_sy,
                             const float* coords, const float* shifts,
                             const float* ref_fw, const float* twiddle,
                             const float* mask, int n, int h, int w,
                             int n_rings, int n_shifts, float* out_val,
                             float* out_row, int* out_aidx, int* out_sidx,
                             int* out_ref, int* out_mirror,
                             cudaStream_t stream) {
  if (ref_group(n_refs) == 1)
    return launch<NMIRR, MASK, 1>(images, acc_sx, acc_sy, coords, shifts,
                                  ref_fw, twiddle, mask, n, h, w, n_rings,
                                  n_shifts, n_refs, out_val, out_row,
                                  out_aidx, out_sidx, out_ref, out_mirror,
                                  stream);
  return launch<NMIRR, MASK, 8>(images, acc_sx, acc_sy, coords, shifts,
                                ref_fw, twiddle, mask, n, h, w, n_rings,
                                n_shifts, n_refs, out_val, out_row, out_aidx,
                                out_sidx, out_ref, out_mirror, stream);
}

extern "C" {

// Launch on `stream`; `mirror` is 0 or 1, `mask` is null for an unmasked
// search.  Returns the cudaError_t of the launch (0 = success).
int cryo_search_launch(const float* images, const float* acc_sx,
                       const float* acc_sy, const float* coords,
                       const float* shifts, const float* ref_fw,
                       const float* twiddle, const float* mask, int n, int h,
                       int w, int n_rings, int n_shifts, int n_refs,
                       int mirror, float* out_val, float* out_row,
                       int* out_aidx, int* out_sidx, int* out_ref,
                       int* out_mirror, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define CRYO_LAUNCH(NM, MK)                                                  \
  launch_kg<NM, MK>(n_refs, images, acc_sx, acc_sy, coords, shifts, ref_fw, \
                    twiddle, mask, n, h, w, n_rings, n_shifts, out_val,     \
                    out_row, out_aidx, out_sidx, out_ref, out_mirror, st)
  cudaError_t err;
  if (mirror)
    err = mask ? CRYO_LAUNCH(2, true) : CRYO_LAUNCH(2, false);
  else
    err = mask ? CRYO_LAUNCH(1, true) : CRYO_LAUNCH(1, false);
#undef CRYO_LAUNCH
  return (int)err;
}

// Dynamic shared memory one block takes for this geometry.
long long cryo_search_smem_bytes(int n_rings, int mirror, int n_refs) {
  return (long long)smem_bytes(n_rings, mirror ? 2 : 1, ref_group(n_refs));
}

const char* cryo_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

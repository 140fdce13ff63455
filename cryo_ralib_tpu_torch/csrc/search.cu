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
// Variants: search_kernel<NMIRR, MASK, KG, STAGE, PICK>, eight production
// instantiations (STAGE_FULL, PICK_ARGMAX) picked at launch
// (cryo_search_launch); each is one static variant of the TPU body:
//   NMIRR=2, MASK=false  the default variant (mirrored, unmasked, full
//                        stage; fused_search.py:129).
//   NMIRR=1              do_mirror=False, --nomirror (fused_search.py:147-152,
//                        :181-183, :289-291, :505-507): the ccf builds and the
//                        inverse FFT inverts the original channel only; m
//                        stays 0 in e, so ties still break by (shift, ref,
//                        angle).
//   MASK=true            has_mask=True, --dst (fused_search.py:162-167,
//                        :389-394, :439-443, :533-535): mask[a] (0 on allowed
//                        bins, -3e38 elsewhere) is added to the value offered
//                        for angle a before the argmax.  The reported peak is
//                        the masked value (equal to the unmasked one on an
//                        allowed bin, where the mask is exactly 0); the
//                        winning row stays unmasked, as the TPU kernel keeps
//                        it.  A masked candidate rounds to exactly -3e38 and
//                        may tie the initial best and take it on its lower e,
//                        but any allowed candidate beats it, so while one bin
//                        is allowed (the wrapper checks) the winner is
//                        allowed.
//   KG=1 or 8            the refs per ccf / inverse-FFT group: 1 when K=1
//                        (the reference-free driver), else 8.  Large K
//                        (fold=True and the ref-axis chunks of
//                        fused_search.py:356-424, :752-781, _merge_chunk
//                        :791) needs no variant: the ref-group loop covers any
//                        K in one launch with the same priority rule.
//   STAGE                the TPU kernel's ablation stages (stage in {no_ccf,
//                        no_yred, sample_only}, :221-233, :329-348), the
//                        mirrored, unmasked instantiations at KG 8 and 1
//                        only, reached through ops/fused_search.py::
//                        fused_search_stage.  Their outputs have the
//                        production shapes and values that mean nothing,
//                        but for sample_only's rows: entry t is the largest
//                        sample thread t drew, floored at 0.  raw4
//                        (:174-176) is a TPU accumulator
//                        layout with the default variant's outputs.
//   PICK=PICK_SHC        stochastic hill climbing, the rule of
//                        ops/search.py::_shc_fold (the TPU package has no
//                        kernel for it), launched by cryo_search_launch
//                        where prevmax is given, for NMIRR 1 and 2, KG 1
//                        (one reference, as the reference-free driver
//                        has; SHC with more runs the plain search),
//                        unmasked.  Stages a-c are shared; stage d
//                        reduces each candidate row (m, s, k) on its own
//                        to its peak and its first argmax angle, and the
//                        block keeps the row of the LOWEST priority
//                        p = (m*S + s)*K + k whose peak is strictly above
//                        the particle's previousmax: as e = p*256 + a, the
//                        least e among passing rows.  A particle with none
//                        keeps value -3e38, a zero row and zero indices.
//                        Mirror is the outermost axis of p, so once a
//                        shift group ends with a winner of m = 0 no later
//                        shift can hold a lower p: the block leaves the
//                        shift loop there (every thread holds the same
//                        best, so the test is block-uniform) and counts
//                        the groups it ran in out_groups.
//
// What bounds it on the H100.  Per particle at the headline geometry
// (R=36, K=8, S=49) the search needs, per shift, 9216 bilinear samples
// (four gathers each), 36 forward and 16 inverse 256-point real FFTs and
// 4*K*R*129 ~ 149 K multiply-adds of the ccf, against a 32 KB image: f32
// arithmetic and on-chip traffic, not device memory.  The ccf reads the
// K x R x 129 ref spectra (297 KB at K=8, 2.4 MB at K=64), too large to
// stay in L1: read once per shift they would be 238 GB per 16384-particle
// headline search, and 80 GB at G=3.  Measured on one H100 SXM at a 700 W
// limit (tools/torch_search_ablate.py): 68 ms per such search with each
// sample's position placed by f64 offsets, floorf, float-to-int
// conversions and the clamp, of which the sampling took ~28 ms (about one
// SM cycle a sample), the ccf ~21 ms, the forward FFTs ~11 ms and the
// inverse FFTs and argmax ~7 ms; with the positions of stage a below, 52
// ms, the sampling ~18 ms (K=1: 46 -> 31 ms, the sampling ~14 ms).  One
// block per SM (the shared memory) leaves 8 warps to hide the latency of
// each stage, and may hold all 255 registers a thread.  What bounds the ccf
// is not measured: G=3 cut its assumed L2 reads threefold against the
// earlier one-shift kernel, yet its time per ref stayed the same (2.65
// against 2.62 ms), which argues against L2 bandwidth.
//
// What the design does about it.  One 256-thread block per particle loops
// over groups of G shifts (G chosen at launch by plan(), up to GMAX; the
// last group is ragged).  For each group:
//   a. samples and forward FFTs.  The G*R rings of the group are packed
//      two by two into complex sequences z = x_a + i x_b: ring r at shifts
//      2i and 2i+1 (one radius, so one f64 offset product and conversion
//      serve both samples of an angle), then the rings of an odd last
//      shift as neighbours r, r+1 (an odd ring count leaves the last ring
//      paired with zeros); the spectra keep their (shift, ring) slots.  A
//      sample's position costs no conversion beyond its offset: its floor
//      is a round-down add of 2^23.  A pair whose rings lie inside the
//      image, by a test on the ring's centre and radius (ring_inside; all
//      rings of the benchmark's jobs), skips the clamp; the samples are
//      bit for bit those of ops/interp.py either way.  Each 256-point FFT
//      runs as 16 x 16 on 16 threads: thread j samples the stride-16 column
//      z[16 n1 + j] straight into registers, takes its 16-point DFT (radix
//      4 x 4, quarter turns exact), multiplies by the 256-point twiddles
//      W^(j k1) (a Python-built table, one column per thread, loaded into
//      registers once), and writes the column transposed to shared memory
//      at a row stride of 17, so that a half-warp hits distinct banks; then
//      thread k1 takes the second 16-point DFT of row k1, which gives
//      Z[k1 + 16 k2].  Sixteen FFTs (two rings each) run per round of 256
//      threads.  The two rings' spectra are split with a warp shuffle:
//      X_a[f] = (Z[f] + conj Z[256-f]) / 2, X_b[f] = (Z[f] - conj Z[256-f])
//      / 2i; a ring stores bins 1..127 and, in slot 0, (DC, Nyquist), both
//      real: their imaginary parts vanish exactly in the split.
//   b. the ccf.  Thread t takes ref t%8 of the group and bins t/8 + 32 i
//      (i = 0..3, all at once, so four ref reads are in flight), so a warp
//      reads 4 spectrum entries (broadcasts) and 32 ref entries per ring;
//      each ref entry, read through the read-only cache, serves all G
//      shifts: G times less L2 traffic than one shift at a time.
//      Slot 0 multiplies (DC, Nyquist) pairs.  Outputs are scaled by 1/256
//      (exact) and stored as rows of (shift, ref, mirror).
//   c. inverse FFTs.  Two real rows in that order are packed into one
//      complex spectrum C = O + i M built from both Hermitian halves (the
//      original and mirror rows of one ref when NMIRR=2, two refs when
//      NMIRR=1 and KG=8, two shifts when NMIRR=1 and KG=1; an odd count
//      pairs the last row with zeros) and inverted by the same 16 x 16 plan
//      with conjugate twiddles: real and imaginary parts are the two angle
//      rows.  Bins f and 256-f enter at 1/256 each (the x2 of a conjugate
//      pair).
//   d. the argmax.  Thread k1 of an FFT holds angles k1 + 16 k2 of both
//      rows; the block reduces (value, e) by the rule above, and the 16
//      threads that hold a new winning row write it to shared memory.
//      Under PICK_SHC the 16 threads of an FFT first reduce each of its
//      two rows to (peak, first argmax angle) with xor shuffles, and the
//      block reduces the passing rows' e.
//
// Shared memory per block: the group's spectra (G*R*128 float2, 36.9 KB
// per shift at R=36), the ccf rows (G*KG*NMIRR rows of 129 or 130 float2,
// padded so the ccf's stores hit distinct banks), the transpose scratch of
// 16 FFTs (34.8 KB), the winning row, the mask and, where plan() stages
// it, the image.  plan() takes the most shifts per group that fit, with
// the image staged unless, at K > 1, staging leaves one shift per group
// against more without it: at 90 px, R=36, the image staged, G=3 and
// 229456 B for the default variant at K=8 (one block per SM; the staged
// image keeps the gathers off the ~28 KB of L1 the shared memory
// leaves); at 160 px, R=48, K=4, G=2 and 168256 B with the image read
// through the read-only cache (__ldg), at K=1 the image staged and G=1;
// at 256 px, R=100, G=1 and 155840 B through the cache.  Any box size
// runs.

#include <cuda_runtime.h>

#define L 256
#define F 129
#define NB 128           // stored bins per spectrum: 1..127, slot 0 (DC, Nyq)
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define NFFT 16          // 256-point FFTs per round (16 threads each)
#define TSTR 17          // row stride (float2) of the transpose scratch
#define TSIZE (16 * TSTR)
#define GMAX 4           // most shifts per group

__device__ __forceinline__ bool beats(float v, int e, float bv, int be) {
  return v > bv || (v == bv && e < be);
}

// Stage d's rule: the exhaustive argmax, or the SHC pick
enum { PICK_ARGMAX = 0, PICK_SHC = 1 };

// Whether candidate (v, e) replaces the best (bv, be) under PICK: by
// value, then priority (argmax), or by priority alone among the passing
// rows (SHC; a row that does not pass carries e = INT_MAX)
template <int PICK>
__device__ __forceinline__ bool takes(float v, int e, float bv, int be) {
  return PICK == PICK_SHC ? e < be : beats(v, e, bv, be);
}

// Pixel `off` past p in the image: from the block's copy in shared memory
// (SMEM) or through the read-only cache.
template <bool SMEM>
__device__ __forceinline__ float pixel(const float* __restrict__ p, int off) {
  return SMEM ? p[off] : __ldg(p + off);
}

// Ablation stages of the default instantiation; production runs STAGE_FULL.
enum { STAGE_FULL = 0, STAGE_NO_CCF = 1, STAGE_SAMPLE_ONLY = 2,
       STAGE_NO_YRED = 3 };

// floor(x) of 0 <= x < 2^22 with no conversion instruction: x + 2^23
// rounded down is 2^23 + floor(x) exactly (floats in [2^23, 2^24) are the
// integers), so its low mantissa bits are floor(x) as an integer.
// Returns floor(x) as a float (exact) and sets i to it.
__device__ __forceinline__ float floor_index(float x, int& i) {
  const float t = __fadd_rd(x, 8388608.f);
  i = __float_as_int(t) - 0x4B000000;   // less the bits of 2^23
  return __fsub_rn(t, 8388608.f);
}

// Bilinear read at (y, x), the operation order of ops/interp.py, with
// explicit round-to-nearest intrinsics so nvcc contracts nothing into
// FMAs.  CLAMP: clamp-to-edge, as interp.py.  Without it the caller
// guarantees 0 <= x <= w-2 and 0 <= y <= h-2, where the clamp's min and
// max are identities: the same bits.  x is never -0 (no offset in the
// tables is -0, and the centre is +0 or more), so floor_index gives the
// x0 and the fx that floorf does.  STAGE_NO_YRED (ablation): the top row
// only (x interpolation, no second pair of gathers), the counterpart of
// the TPU's slice in place of the y-tent contraction.
template <int STAGE, bool SMEM, bool CLAMP>
__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                          int h, int w, float y, float x) {
  if (CLAMP) {
    x = fminf(fmaxf(x, 0.f), (float)(w - 1));
    y = fminf(fmaxf(y, 0.f), (float)(h - 1));
  }
  int ix0, iy0;
  const float x0 = floor_index(x, ix0), y0 = floor_index(y, iy0);
  const int dx = CLAMP ? min(ix0 + 1, w - 1) - ix0 : 1;        // to ix1
  const int dy = CLAMP ? (min(iy0 + 1, h - 1) - iy0) * w : w;  // to iy1
  const float* p = img + iy0 * w + ix0;
  const float fx = __fsub_rn(x, x0), gx = __fsub_rn(1.f, fx);
  const float top = __fadd_rn(__fmul_rn(pixel<SMEM>(p, 0), gx),
                              __fmul_rn(pixel<SMEM>(p, dx), fx));
  if (STAGE == STAGE_NO_YRED) return top;
  const float fy = __fsub_rn(y, y0), gy = __fsub_rn(1.f, fy);
  const float bot = __fadd_rn(__fmul_rn(pixel<SMEM>(p, dy), gx),
                              __fmul_rn(pixel<SMEM>(p, dy + dx), fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// The polar offset of a sample: f32(cos_or_sin(angle) * radius), the f64
// product rounded once, bitwise what config.polar_coords holds (numpy's
// f64 product cast to f32).
__device__ __forceinline__ float polar_offset(double cs, double radius) {
  return __double2float_rn(__dmul_rn(cs, radius));
}

// Whether every sample of the ring of radius `rad` around (bx, by) lies in
// [0, w-2] x [0, h-2], where bilinear needs no clamp.  An offset is
// f32(cs * rad) with |cs| <= 1, so |offset| <= f32(rad) = r (rounding is
// monotonic), and by the same monotony a sample f32(b + offset) lies
// between f32(b - r) and f32(b + r), which the test bounds.  NaN fails.
// tests/test_torch_sample_interior.py holds the rule in numpy.
__device__ __forceinline__ bool ring_inside(float bx, float by, double rad,
                                            int h, int w) {
  const float r = __double2float_rn(rad);
  return __fsub_rn(bx, r) >= 0.f && __fsub_rn(by, r) >= 0.f &&
         __fadd_rn(bx, r) <= (float)(w - 2) &&
         __fadd_rn(by, r) <= (float)(h - 2);
}

// The samples of one ring pair for thread j of its FFT: v[n1] = (ring a,
// ring b) at angle 16 n1 + j, for the first pass of the forward FFT.  A
// missing ring b (has_b) gives zeros.  The (cos, sin) of an angle (4 KB
// for all, L1-resident) serves both rings; where they are one ring at two
// shifts (ONE_RING: rad_b is rad_a, and ring b is always there) so does
// its offset.  CLAMP as bilinear's.
template <int STAGE, bool SMEM, bool CLAMP, bool ONE_RING>
__device__ __forceinline__ void sample_pair(
    float2 (&v)[16], const float* __restrict__ img, int h, int w,
    const double2* __restrict__ polar, double rad_a, double rad_b,
    float bxa, float bya, float bxb, float byb, bool has_b, int j) {
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1) {
    const double2 cs = __ldg(polar + 16 * n1 + j);
    const float oxa = polar_offset(cs.x, rad_a);
    const float oya = polar_offset(cs.y, rad_a);
    const float va = bilinear<STAGE, SMEM, CLAMP>(
        img, h, w, __fadd_rn(bya, oya), __fadd_rn(bxa, oxa));
    float vb = 0.f;
    if (ONE_RING || has_b) {
      const float oxb = ONE_RING ? oxa : polar_offset(cs.x, rad_b);
      const float oyb = ONE_RING ? oya : polar_offset(cs.y, rad_b);
      vb = bilinear<STAGE, SMEM, CLAMP>(img, h, w, __fadd_rn(byb, oyb),
                                        __fadd_rn(bxb, oxb));
    }
    v[n1] = make_float2(va, vb);
  }
}

// sample_pair's path for a pair: clamped unless both rings lie inside
// (uniform over the FFT's 16 threads, so a warp splits only where its two
// FFTs differ); a clamped pair of one ring computes its offsets twice,
// the same bits.
template <int STAGE, bool SMEM>
__device__ __forceinline__ void sample_rings(
    float2 (&v)[16], const float* __restrict__ img, int h, int w,
    const double2* __restrict__ polar, double rad_a, double rad_b,
    float bxa, float bya, float bxb, float byb, bool has_b, bool one_ring,
    bool inside, int j) {
  if (!inside)
    sample_pair<STAGE, SMEM, true, false>(v, img, h, w, polar, rad_a, rad_b,
                                          bxa, bya, bxb, byb, has_b, j);
  else if (one_ring)
    sample_pair<STAGE, SMEM, false, true>(v, img, h, w, polar, rad_a, rad_b,
                                          bxa, bya, bxb, byb, has_b, j);
  else
    sample_pair<STAGE, SMEM, false, false>(v, img, h, w, polar, rad_a, rad_b,
                                           bxa, bya, bxb, byb, has_b, j);
}

// ---- complex arithmetic and the 16-point DFT in registers.  SIGN = -1 is
// the forward transform (W = e^(-2 pi i / n)), +1 the inverse (unscaled).

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (SIGN i): a quarter turn, exact
template <int SIGN>
__device__ __forceinline__ float2 qturn(float2 a) {
  return SIGN < 0 ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
}

template <int SIGN>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = qturn<SIGN>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// W16^e = (cos(2 pi e / 16), SIGN sin(2 pi e / 16)) for the exponents
// n2 * k1 (n2, k1 in 1..3, e != 4) of the radix-4 x 4 plan
template <int SIGN>
__device__ __forceinline__ float2 w16(int e) {
  const float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f;
  const float h = 0.70710678118654757f;
  float c = 0.f, s = 0.f;
  switch (e) {
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 6: c = -h; s = h; break;
    case 9: c = -c1; s = -s1; break;
  }
  return make_float2(c, SIGN * s);
}

// In-place 16-point DFT: v[k] <- sum_n v[n] W16^(n k).  n = n2 + 4 n1,
// k = k1 + 4 k2: 4-point DFTs over n1, twiddles W16^(n2 k1), 4-point DFTs
// over n2.
template <int SIGN>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2)   // T[n2][k1] lands in v[n2 + 4 k1]
    dft4<SIGN>(v[n2], v[n2 + 4], v[n2 + 8], v[n2 + 12]);
#pragma unroll
  for (int n2 = 1; n2 < 4; ++n2)
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
      v[n2 + 4 * k1] = (n2 * k1 == 4) ? qturn<SIGN>(v[n2 + 4 * k1])
                                      : cmul(v[n2 + 4 * k1], w16<SIGN>(n2 * k1));
  float2 o[16];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    dft4<SIGN>(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) o[k1 + 4 * k2] = v[4 * k1 + k2];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = o[k];
}

// The rest of a 256-point FFT on thread j of its 16, after the first
// 16-point pass over its column: the twiddles W256^(SIGN j k1), the
// column to the transpose scratch `sc` (this FFT's 16 x TSTR float2), a
// block barrier, row j back and its 16-point DFT: on return
// v[k2] = Z[j + 16 k2].  The caller synchronises before `sc` is written
// again.
template <int SIGN>
__device__ __forceinline__ void fft256_second_half(float2 (&v)[16],
                                                   const float2 (&tw)[16],
                                                   float2* sc, int j) {
#pragma unroll
  for (int k1 = 1; k1 < 16; ++k1)
    v[k1] = cmul(v[k1], SIGN < 0 ? tw[k1] : make_float2(tw[k1].x, -tw[k1].y));
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) sc[k1 * TSTR + j] = v[k1];
  __syncthreads();
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) v[n2] = sc[j * TSTR + n2];
  dft16<SIGN>(v);
}

// ccf row stride (float2): 129 or 130 puts the 8 refs of a half-warp's
// stores on distinct banks
__host__ __device__ constexpr int x_stride(int n_mirr) {
  return n_mirr == 2 ? 129 : 130;
}

// b. The ccf of GC shifts' spectra (slot layout) with refs k0 .. k0+kn-1
// into the rows X[(g * kn + kl) * NMIRR + m], scaled by 1/L; slot 0
// carries (DC, Nyquist).  Thread t takes ref kl = t % KG and the bins
// fs0 + FSTEP i, all at once, so that SLOTS ref reads per ring are in
// flight; each serves the GC shifts.  ZERO (the no_ccf stage) writes
// zero rows.
template <int NMIRR, int KG, int GC, bool ZERO>
__device__ __forceinline__ void ccf(const float2* __restrict__ spec,
                                    const float2* __restrict__ ref_fw,
                                    float2* __restrict__ X, int n_rings,
                                    int k0, int kn, int t) {
  constexpr int XS = x_stride(NMIRR);
  constexpr int SLOTS = (KG * NB + NTHREADS - 1) / NTHREADS;
  constexpr int FSTEP = NTHREADS / KG;
  const int kl = t % KG, fs0 = t / KG;
  if (kl >= kn || fs0 >= NB) return;   // KG=1: threads 128.. idle
  float acc[SLOTS][GC][4];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i)
#pragma unroll
    for (int g = 0; g < GC; ++g)
      acc[i][g][0] = acc[i][g][1] = acc[i][g][2] = acc[i][g][3] = 0.f;
  if (!ZERO) {
    const float2* rp = ref_fw + (size_t)(k0 + kl) * n_rings * F + fs0;
    const float* nyq = reinterpret_cast<const float*>(
        ref_fw + (size_t)(k0 + kl) * n_rings * F + L / 2);
#pragma unroll 2
    for (int r = 0; r < n_rings; ++r) {
      float2 rr[SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i)
        rr[i] = __ldg(rp + (size_t)r * F + FSTEP * i);
      if (fs0 == 0) rr[0].y = __ldg(nyq + 2 * (size_t)r * F);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float2* sp = spec + (g * n_rings + r) * NB + fs0;
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          const float2 sv = sp[FSTEP * i];
          acc[i][g][0] = fmaf(sv.x, rr[i].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(sv.y, rr[i].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(sv.x, rr[i].y, acc[i][g][2]);
          acc[i][g][3] = fmaf(sv.y, rr[i].x, acc[i][g][3]);
        }
      }
    }
  }
  const float sc_l = 1.f / L;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const int row = (g * kn + kl) * NMIRR;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const float a = acc[i][g][0], b = acc[i][g][1];
      const float c = acc[i][g][2], d = acc[i][g][3];
      const int fs = fs0 + FSTEP * i;
      float2 xo, xm;
      if (fs == 0) {   // DC and Nyquist: a and b, the same in both
        xo = xm = make_float2(a * sc_l, b * sc_l);
      } else {
        xo = make_float2((a + b) * sc_l, (c - d) * sc_l);
        xm = make_float2((a - b) * sc_l, -(c + d) * sc_l);
      }
      X[row * XS + fs] = xo;
      if (NMIRR == 2) X[(row + 1) * XS + fs] = xm;
    }
  }
}

// ---- geometry of a launch

static inline int ref_group(int n_refs) { return n_refs == 1 ? 1 : 8; }

static inline size_t smem_bytes(int n_rings, int n_mirr, int kg, int g) {
  return sizeof(float2) * ((size_t)g * n_rings * NB            // spectra
                           + (size_t)g * kg * n_mirr * x_stride(n_mirr)
                           + NFFT * TSIZE)                      // scratch
         + sizeof(float) * (2 * L + 2 * NWARPS);  // row, mask, partials
}

static inline int smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

// The launch's plan: shifts per group (G) and whether the image is staged
// in shared memory.  Staging takes the image off the L1 cache, a larger G
// divides the ccf's ref reads; where both do not fit, the plan keeps the
// staged image unless that leaves G=1 against a larger G without it in a
// search of ref groups of 8 (KG=8), whose ccf pays for G=1.  Measured on
// an H100 (tools/torch_search_ab.py), the staged plan against the
// unstaged one: 90 px, R=36: K=8 68.0 ms (G=3) against 88.9 (G=3), K=1
// 43.9 (G=4) against 63.5 (G=4); 160 px, R=48: K=4 35.6 (G=1) against
// 30.5 (G=2), K=1 21.2 (G=1) against 25.4 (G=3).  A block too large even
// at G=1 is refused by the wrapper.
struct Plan {
  int group;
  bool image;
  size_t smem;
};

// The most shifts per group (up to GMAX and S) that fit beside `extra`
// bytes, or 0 if not even one does.
static inline int max_group(int n_rings, int n_mirr, int kg, int n_shifts,
                            size_t extra, size_t limit) {
  int g = 0;
  while (g < GMAX && g < n_shifts &&
         smem_bytes(n_rings, n_mirr, kg, g + 1) + extra <= limit)
    ++g;
  return g;
}

static inline Plan plan(int n_rings, int n_mirr, int kg, int n_shifts,
                        int h, int w) {
  const size_t limit = (size_t)smem_limit();
  const size_t image = sizeof(float) * (size_t)h * w;
  const int g_staged = max_group(n_rings, n_mirr, kg, n_shifts, image, limit);
  int g_ldg = max_group(n_rings, n_mirr, kg, n_shifts, 0, limit);
  if (g_ldg < 1) g_ldg = 1;
  if (g_staged >= 2 || (g_staged == 1 && (g_ldg == 1 || kg == 1)))
    return {g_staged, true, smem_bytes(n_rings, n_mirr, kg, g_staged) + image};
  return {g_ldg, false, smem_bytes(n_rings, n_mirr, kg, g_ldg)};
}

// One block per SM at the rib80s geometry (the shared memory), so the
// block may take every register: without the 1, ptxas held the K=1
// instantiations to 128 registers and spilled.  A box and ring count
// small enough for two blocks' shared memory run one block an SM.
template <int NMIRR, bool MASK, int KG, int STAGE, int PICK>
__global__ void __launch_bounds__(NTHREADS, 1)
search_kernel(const float* __restrict__ images,   // (N, H, W)
              const float* __restrict__ acc_sx,   // (N,) accumulated shifts
              const float* __restrict__ acc_sy,   // (N,)
              const double2* __restrict__ polar,  // (L,) (cos, sin) of angles
              const double* __restrict__ radii,   // (R,) ring radii
              const float* __restrict__ shifts,   // (S, 2) grid shifts
              const float2* __restrict__ ref_fw,  // (K, R, F) ref spectra
              const float2* __restrict__ twiddle, // (16, 16): [k1][j] W256^(j k1)
              const float* __restrict__ mask,     // (L,) angle mask if MASK
              const float* __restrict__ prevmax,  // (N,) SHC threshold if SHC
              int h, int w, int n_rings, int n_shifts, int n_refs,
              int group,                          // shifts per group (G)
              int image_in_smem,                  // the image is staged
              float* __restrict__ out_val,        // (N,)
              float* __restrict__ out_row,        // (N, L)
              int* __restrict__ out_aidx, int* __restrict__ out_sidx,
              int* __restrict__ out_ref, int* __restrict__ out_mirror,
              int* __restrict__ out_groups,       // (N,) groups run if SHC
              int* __restrict__ out_interior) {   // (N,) zeroed, or null
  static_assert(GMAX == 4, "the ccf switch covers groups of 1 to 4 shifts");
  constexpr int XS = x_stride(NMIRR);
  extern __shared__ __align__(16) float2 smem[];
  float2* spec = smem;                                  // G * R * NB
  float2* X = spec + (size_t)group * n_rings * NB;      // G * KG * NMIRR * XS
  float2* scr = X + group * KG * NMIRR * XS;            // NFFT * TSIZE
  float* best_row = (float*)(scr + NFFT * TSIZE);       // L
  float* mask_s = best_row + L;                         // L
  float* red_v = mask_s + L;                            // NWARPS
  int* red_e = (int*)(red_v + NWARPS);                  // NWARPS
  float* img_s = (float*)(red_e + NWARPS);              // H * W if staged

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int q = t >> 4;   // this thread's FFT of a round
  const int j = t & 15;   // its column (first pass) and row (second pass)
  // the shuffle partner that holds Z[256 - f] for f = j + 16 k2
  const int partner = (lane & 16) | ((16 - j) & 15);
  float2* sc = scr + q * TSIZE;

  float2 tw[16];   // W256^(j k1), forward
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) tw[k1] = twiddle[k1 * 16 + j];
  best_row[t] = 0.f;
  mask_s[t] = MASK ? mask[t] : 0.f;

  const float* img = images + (size_t)n * h * w;
  if (image_in_smem)
    for (int i = t; i < h * w; i += NTHREADS) img_s[i] = __ldg(img + i);
  const float ax = acc_sx[n], ay = acc_sy[n];
  const float cx = (float)(w / 2), cy = (float)(h / 2);

  float best_v = -3.0e38f;  // identical in every thread
  int best_e = 0x7fffffff;
  float smax = -3.0e38f;    // ablation sink: the largest sample seen
  const float pm = PICK == PICK_SHC ? prevmax[n] : 0.f;
  int groups = 0;           // SHC: the shift groups run
  int interior = 0;         // thread j = 0: its rings sampled unclamped
  __syncthreads();

  for (int s0 = 0; s0 < n_shifts; s0 += group) {
    const int gc = min(group, n_shifts - s0);
    // the group's ring pairs: ring r at shifts 2i and 2i + 1 (one radius,
    // so one offset product serves both), then an odd last shift's rings
    // two by two (an odd ring count pairs its last ring with zeros)
    const int n_cross = gc / 2 * n_rings;
    const int n_pairs = n_cross + (gc & 1) * ((n_rings + 1) / 2);

    // a. samples and forward FFTs, 16 ring pairs per round
    for (int p0 = 0; p0 < n_pairs; p0 += NFFT) {
      const int p = p0 + q;
      const bool act = p < n_pairs;
      const bool one_ring = p < n_cross;
      int ia, ib;   // the slots g * R + r of rings a and b
      bool has_b = act;
      if (one_ring) {
        const int gp = p / n_rings;
        ia = 2 * gp * n_rings + (p - gp * n_rings);
        ib = ia + n_rings;
      } else {
        const int r = act ? 2 * (p - n_cross) : 0;
        ia = act ? (gc - 1) * n_rings + r : 0;
        has_b = act && r + 1 < n_rings;
        ib = has_b ? ia + 1 : ia;
      }
      const int ga = ia / n_rings, ra = ia - ga * n_rings;
      const int gb = ib / n_rings, rb = ib - gb * n_rings;
      const float bxa = __fadd_rn(cx, __fadd_rn(ax, shifts[2 * (s0 + ga)]));
      const float bya = __fadd_rn(cy, __fadd_rn(ay, shifts[2 * (s0 + ga) + 1]));
      const float bxb = __fadd_rn(cx, __fadd_rn(ax, shifts[2 * (s0 + gb)]));
      const float byb = __fadd_rn(cy, __fadd_rn(ay, shifts[2 * (s0 + gb) + 1]));
      const double rad_a = __ldg(radii + ra), rad_b = __ldg(radii + rb);
      const bool inside = ring_inside(bxa, bya, rad_a, h, w) &&
                          (!has_b || ring_inside(bxb, byb, rad_b, h, w));
      if (act && inside && j == 0) interior += has_b ? 2 : 1;
      float2 v[16];
      if (!act) {
#pragma unroll
        for (int n1 = 0; n1 < 16; ++n1) v[n1] = make_float2(0.f, 0.f);
      } else if (image_in_smem) {
        sample_rings<STAGE, true>(v, img_s, h, w, polar, rad_a, rad_b, bxa,
                                  bya, bxb, byb, has_b, one_ring, inside, j);
      } else {
        sample_rings<STAGE, false>(v, img, h, w, polar, rad_a, rad_b, bxa,
                                   bya, bxb, byb, has_b, one_ring, inside, j);
      }
      if (STAGE == STAGE_NO_CCF || STAGE == STAGE_SAMPLE_ONLY) {
#pragma unroll
        for (int n1 = 0; n1 < 16; ++n1)
          smax = fmaxf(smax, fmaxf(v[n1].x, v[n1].y));
        continue;
      }
      dft16<-1>(v);
      fft256_second_half<-1>(v, tw, sc, j);
      // split the two rings' spectra; thread j = 0 pairs with itself
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) {
        float2 pz;
        pz.x = __shfl_sync(0xffffffffu, v[15 - k2].x, partner);
        pz.y = __shfl_sync(0xffffffffu, v[15 - k2].y, partner);
        if (j == 0) pz = v[(16 - k2) & 15];
        const float2 z = v[k2];
        float2 xa = make_float2(0.5f * (z.x + pz.x), 0.5f * (z.y - pz.y));
        float2 xb = make_float2(0.5f * (z.y + pz.y), 0.5f * (pz.x - z.x));
        if (k2 == 0 && j == 0) {   // slot 0: (DC, Nyquist), both real
          xa = make_float2(z.x, v[8].x);
          xb = make_float2(z.y, v[8].y);
        }
        if (act) spec[ia * NB + j + 16 * k2] = xa;
        if (has_b) spec[ib * NB + j + 16 * k2] = xb;
      }
      __syncthreads();  // the next round's columns overwrite the scratch
    }

    // (sample_only stops after the samples)
    for (int k0 = 0; STAGE != STAGE_SAMPLE_ONLY && k0 < n_refs; k0 += KG) {
      const int kn = min(KG, n_refs - k0);
      const int n_rows = gc * kn * NMIRR;   // rows (shift, ref, mirror)

      // b. ccf of the group's spectra with refs k0 .. k0+kn-1
      switch (gc) {   // the shifts of a group as a compile-time count
        case 1: ccf<NMIRR, KG, 1, STAGE == STAGE_NO_CCF>(
                    spec, ref_fw, X, n_rings, k0, kn, t); break;
        case 2: ccf<NMIRR, KG, 2, STAGE == STAGE_NO_CCF>(
                    spec, ref_fw, X, n_rings, k0, kn, t); break;
        case 3: ccf<NMIRR, KG, 3, STAGE == STAGE_NO_CCF>(
                    spec, ref_fw, X, n_rings, k0, kn, t); break;
        default: ccf<NMIRR, KG, GMAX, STAGE == STAGE_NO_CCF>(
                    spec, ref_fw, X, n_rings, k0, kn, t);
      }
      __syncthreads();

      // c. inverse FFTs of row pairs, 16 per round, and d. the argmax
      const int n_fft = (n_rows + 1) / 2;
      for (int c0 = 0; c0 < n_fft; c0 += NFFT) {
        const int ci = c0 + q;
        const bool act = ci < n_fft;
        const int r0 = act ? 2 * ci : 0;
        const bool has1 = act && r0 + 1 < n_rows;
        const float2* x0 = X + r0 * XS;
        const float2* x1 = X + (has1 ? r0 + 1 : r0) * XS;
        float2 v[16];
#pragma unroll
        for (int n1 = 0; n1 < 16; ++n1) {   // C[f], f = 16 n1 + j
          const int f = 16 * n1 + j;
          const bool edge = j == 0 && (n1 == 0 || n1 == 8);  // DC, Nyquist
          const int fi = edge ? 0 : (n1 < 8 ? f : L - f);
          const float2 A = x0[fi];
          float2 B = x1[fi];
          if (!has1) B = make_float2(0.f, 0.f);
          if (edge)
            v[n1] = n1 == 0 ? make_float2(A.x, B.x) : make_float2(A.y, B.y);
          else if (n1 < 8)    // O[f] + i M[f]
            v[n1] = make_float2(A.x - B.y, A.y + B.x);
          else                // conj(O[256-f]) + i conj(M[256-f])
            v[n1] = make_float2(A.x + B.y, B.x - A.y);
        }
        dft16<1>(v);
        fft256_second_half<1>(v, tw, sc, j);

        // rows r0 (real parts) and r0+1 (imaginary parts), angles j + 16 k2
        float tv = -3.0e38f;
        int te = 0x7fffffff;
        if (PICK == PICK_ARGMAX && act) {
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            if (part == 1 && !has1) break;
            const int row = r0 + part;
            const int m = row % NMIRR, gk = row / NMIRR;
            const int kr = gk % kn, g = gk / kn;
            const int e0 = ((m * n_shifts + s0 + g) * n_refs + k0 + kr) * L;
#pragma unroll
            for (int k2 = 0; k2 < 16; ++k2) {
              const int a = j + 16 * k2;
              const float raw = part ? v[k2].y : v[k2].x;
              const float val = MASK ? raw + mask_s[a] : raw;
              if (beats(val, e0 + a, tv, te)) { tv = val; te = e0 + a; }
            }
          }
        }
        if (PICK == PICK_SHC) {
          // each row's peak and its lowest angle among equal values, over
          // the FFT's 16 threads (xor shuffles stay inside the half-warp)
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            float pv = part ? v[0].y : v[0].x;
            int pa = j;
#pragma unroll
            for (int k2 = 1; k2 < 16; ++k2) {
              const float raw = part ? v[k2].y : v[k2].x;
              if (raw > pv) { pv = raw; pa = j + 16 * k2; }
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) {
              const float ov = __shfl_xor_sync(0xffffffffu, pv, off);
              const int oa = __shfl_xor_sync(0xffffffffu, pa, off);
              if (beats(ov, oa, pv, pa)) { pv = ov; pa = oa; }
            }
            const int row = r0 + part;
            const int m = row % NMIRR, gk = row / NMIRR;
            const int kr = gk % kn, g = gk / kn;
            const int e = ((m * n_shifts + s0 + g) * n_refs + k0 + kr) * L + pa;
            if (act && (part == 0 || has1) && pv > pm && e < te) {
              tv = pv;
              te = e;
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, tv, off);
          const int oe = __shfl_down_sync(0xffffffffu, te, off);
          if (takes<PICK>(ov, oe, tv, te)) { tv = ov; te = oe; }
        }
        if (lane == 0) { red_v[warp] = tv; red_e[warp] = te; }
        __syncthreads();
        float gv = red_v[0];
        int ge = red_e[0];
#pragma unroll
        for (int i = 1; i < NWARPS; ++i)
          if (takes<PICK>(red_v[i], red_e[i], gv, ge)) {
            gv = red_v[i];
            ge = red_e[i];
          }
        if (takes<PICK>(gv, ge, best_v, best_e)) {
          best_v = gv;
          best_e = ge;
          const int rest = ge / L;
          const int kw = rest % n_refs, sw = (rest / n_refs) % n_shifts;
          const int mw = rest / n_refs / n_shifts;
          const int row = ((sw - s0) * kn + kw - k0) * NMIRR + mw;
          if (act && (row >> 1) == ci) {   // this FFT holds the winning row
#pragma unroll
            for (int k2 = 0; k2 < 16; ++k2)
              best_row[j + 16 * k2] = (row & 1) ? v[k2].y : v[k2].x;  // unmasked
          }
        }
        // the partials and the scratch are rewritten only after the next
        // round's first barrier
      }
    }
    if (PICK == PICK_SHC) {
      ++groups;
      // a winner of m = 0 (p < S*K): no later shift holds a lower p
      if (best_e != 0x7fffffff && best_e / L / n_refs < n_shifts) break;
    }
  }

  __syncthreads();
  // an ablated stage's outputs have the production shapes, and values
  // that mean nothing (the sink keeps the samples from being optimised out)
  out_row[(size_t)n * L + t] = STAGE == STAGE_FULL ? best_row[t]
                                                   : fmaxf(best_row[t], smax);
  if (t == 0) {
    // SHC with no passing row: zero indices (the row stayed zero)
    const bool none = PICK == PICK_SHC && best_e == 0x7fffffff;
    const int e = none ? 0 : best_e;
    const int rest = e / L;
    out_val[n] = best_v;
    out_aidx[n] = e % L;
    out_ref[n] = rest % n_refs;
    out_sidx[n] = (rest / n_refs) % n_shifts;
    out_mirror[n] = rest / n_refs / n_shifts;
    if (PICK == PICK_SHC) out_groups[n] = groups;
  }
  if (out_interior != nullptr && interior > 0)
    atomicAdd(out_interior + n, interior);
}

template <int NMIRR, bool MASK, int KG, int STAGE = STAGE_FULL,
          int PICK = PICK_ARGMAX>
static cudaError_t launch(const float* images, const float* acc_sx,
                          const float* acc_sy, const double* polar,
                          const double* radii, const float* shifts,
                          const float* ref_fw,
                          const float* twiddle, const float* mask,
                          const float* prevmax, int n,
                          int h, int w, int n_rings, int n_shifts, int n_refs,
                          float* out_val, float* out_row, int* out_aidx,
                          int* out_sidx, int* out_ref, int* out_mirror,
                          int* out_groups, int* out_interior,
                          cudaStream_t stream) {
  const Plan pl = plan(n_rings, NMIRR, KG, n_shifts, h, w);
  cudaError_t err = cudaFuncSetAttribute(
      search_kernel<NMIRR, MASK, KG, STAGE, PICK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  search_kernel<NMIRR, MASK, KG, STAGE, PICK>
      <<<n, NTHREADS, pl.smem, stream>>>(
      images, acc_sx, acc_sy, (const double2*)polar, radii, shifts,
      (const float2*)ref_fw, (const float2*)twiddle, mask, prevmax, h, w,
      n_rings, n_shifts, n_refs, pl.group, (int)pl.image, out_val, out_row,
      out_aidx, out_sidx, out_ref, out_mirror, out_groups, out_interior);
  return cudaGetLastError();
}

template <int NMIRR, bool MASK>
static cudaError_t launch_kg(int n_refs, const float* images,
                             const float* acc_sx, const float* acc_sy,
                             const double* polar, const double* radii,
                             const float* shifts, const float* ref_fw,
                             const float* twiddle, const float* mask, int n,
                             int h, int w, int n_rings, int n_shifts,
                             float* out_val, float* out_row, int* out_aidx,
                             int* out_sidx, int* out_ref, int* out_mirror,
                             int* out_interior, cudaStream_t stream) {
  if (ref_group(n_refs) == 1)
    return launch<NMIRR, MASK, 1>(images, acc_sx, acc_sy, polar, radii,
                                  shifts, ref_fw, twiddle, mask, nullptr, n,
                                  h, w, n_rings, n_shifts, n_refs, out_val,
                                  out_row, out_aidx, out_sidx, out_ref,
                                  out_mirror, nullptr, out_interior, stream);
  return launch<NMIRR, MASK, 8>(images, acc_sx, acc_sy, polar, radii, shifts,
                                ref_fw, twiddle, mask, nullptr, n, h, w,
                                n_rings, n_shifts, n_refs, out_val, out_row,
                                out_aidx, out_sidx, out_ref, out_mirror,
                                nullptr, out_interior, stream);
}

extern "C" {

// Launch on `stream`; `mirror` is 0 or 1, `mask` is null for an unmasked
// search, `stage` 0 (STAGE_FULL) except in the ablation harness, which
// takes the mirrored, unmasked instantiations at KG 8 and 1 only; `polar`
// and `radii` are the f64 tables of ops/fused_search.py::polar_tables,
// `twiddle` the (16, 16) complex table of ops/fused_search.py::
// fft_twiddles.  A non-null `prevmax`, the (N,) f32 thresholds, picks the
// SHC search (PICK_SHC: one reference, unmasked, full stage), which writes
// the shift groups each block ran to the (N,) int32 `out_groups`;
// otherwise both are null.  A non-null `out_interior`, (N,) int32 zeros,
// receives per particle the ring samplings (shift, ring) that took the
// unclamped path.  Returns the cudaError_t of the launch (0 = success).
int cryo_search_launch(const float* images, const float* acc_sx,
                       const float* acc_sy, const double* polar,
                       const double* radii, const float* shifts,
                       const float* ref_fw, const float* twiddle,
                       const float* mask, const float* prevmax, int n, int h,
                       int w, int n_rings, int n_shifts, int n_refs,
                       int mirror, int stage, float* out_val, float* out_row,
                       int* out_aidx, int* out_sidx, int* out_ref,
                       int* out_mirror, int* out_groups, int* out_interior,
                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (prevmax) {
    if (mask || stage != STAGE_FULL || !out_groups || n_refs != 1)
      return (int)cudaErrorInvalidValue;
#define CRYO_SHC(NM)                                                          \
  launch<NM, false, 1, STAGE_FULL, PICK_SHC>(                                \
      images, acc_sx, acc_sy, polar, radii, shifts, ref_fw, twiddle,         \
      nullptr, prevmax, n, h, w, n_rings, n_shifts, n_refs, out_val,         \
      out_row, out_aidx, out_sidx, out_ref, out_mirror, out_groups,          \
      out_interior, st)
    const cudaError_t err = mirror ? CRYO_SHC(2) : CRYO_SHC(1);
#undef CRYO_SHC
    return (int)err;
  }
  if (stage != STAGE_FULL) {
    if (!mirror || mask)
      return (int)cudaErrorInvalidValue;
#define CRYO_STAGE(KG, ST)                                                    \
  launch<2, false, KG, ST>(images, acc_sx, acc_sy, polar, radii, shifts,     \
                           ref_fw, twiddle, mask, nullptr, n, h, w, n_rings, \
                           n_shifts, n_refs, out_val, out_row, out_aidx,     \
                           out_sidx, out_ref, out_mirror, nullptr,           \
                           out_interior, st)
#define CRYO_STAGE_KG(ST)                                                     \
  (ref_group(n_refs) == 1 ? CRYO_STAGE(1, ST) : CRYO_STAGE(8, ST))
    cudaError_t err = cudaErrorInvalidValue;
    if (stage == STAGE_NO_CCF) err = CRYO_STAGE_KG(STAGE_NO_CCF);
    if (stage == STAGE_SAMPLE_ONLY) err = CRYO_STAGE_KG(STAGE_SAMPLE_ONLY);
    if (stage == STAGE_NO_YRED) err = CRYO_STAGE_KG(STAGE_NO_YRED);
#undef CRYO_STAGE_KG
#undef CRYO_STAGE
    return (int)err;
  }
#define CRYO_LAUNCH(NM, MK)                                                  \
  launch_kg<NM, MK>(n_refs, images, acc_sx, acc_sy, polar, radii, shifts,   \
                    ref_fw, twiddle, mask, n, h, w, n_rings, n_shifts,      \
                    out_val, out_row, out_aidx, out_sidx, out_ref,          \
                    out_mirror, out_interior, st)
  cudaError_t err;
  if (mirror)
    err = mask ? CRYO_LAUNCH(2, true) : CRYO_LAUNCH(2, false);
  else
    err = mask ? CRYO_LAUNCH(1, true) : CRYO_LAUNCH(1, false);
#undef CRYO_LAUNCH
  return (int)err;
}

// The plan of a launch at this geometry on the current device: returns
// the dynamic shared memory of one block and sets the shifts per group
// (G) and whether the image is staged in shared memory.
long long cryo_search_plan(int n_rings, int mirror, int n_refs, int n_shifts,
                           int h, int w, int* group, int* image_in_smem) {
  const Plan pl = plan(n_rings, mirror ? 2 : 1, ref_group(n_refs), n_shifts,
                       h, w);
  *group = pl.group;
  *image_in_smem = (int)pl.image;
  return (long long)pl.smem;
}

const char* cryo_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

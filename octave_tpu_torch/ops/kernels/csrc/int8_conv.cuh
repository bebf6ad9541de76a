// The int8 conv kernel: see int8_conv.cu for what it computes and why.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace octave {

constexpr int kThreads = 256;
constexpr int kBK = 64;            // K bytes per stage: two m16n8k32 steps
constexpr int kPitch = kBK + 16;   // 80-byte rows: fragment reads hit 32 banks

struct Source {
  const void* x;      // NHWC activation (B, H, W, c)
  const int8_t* w;    // packed weight, (n_rows, ldw) int8, K contiguous
  const float* ws;    // (N or C_out,) per-output-channel weight scales
  const float* sx;    // the activation scale, a float32 scalar
  int c;              // C_in of this activation
  int k;              // kh * kw * c
  int ldw;            // row pitch of w (k rounded up to 8)
  int n_rows;         // rows of w
};

struct Params {
  Source src[2];
  int nsrc;           // 2: the pair
  const void* bias;   // (N or C_out,) or null
  int bias_f32;       // bias is float32 (else the output dtype)
  void* out;
  int h, w;           // input height, width
  int ho, wo;         // output rows' height, width (the input's in transpose mode)
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int n;              // GEMM columns
  int cout;           // output channels (n, or n / 4 in transpose mode)
  int transpose;
  int store2;         // column pairs may be stored as one 2-element vector
  long long m;        // GEMM rows
  int tr, tc;         // halo path: output tile rows and columns (tr * tc <= 128)
  int row_tiles, col_tiles;
};

template <typename T> struct Ty;
template <> struct Ty<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Ty<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Ty<__half> {
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_f(float v) { return __float2half_rn(v); }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Ty<T>::to_f(Ty<T>::from_f(v));
}

// element i of 4 words (i a compile-time constant once unrolled: the
// values stay in registers, no local-memory array)
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the value of the 16 bits of a bf16 or float16 element
__device__ __forceinline__ float from_bits(uint32_t b, const __nv_bfloat16*) {
  return __uint_as_float(b << 16);
}
__device__ __forceinline__ float from_bits(uint32_t b, const __half*) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}
__device__ __forceinline__ uint32_t to_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t to_bits(__half v) { return __half_as_ushort(v); }

// q = clamp(rint(x / sx), -127, 127), in the low byte of the returned
// word. x / sx is taken as x * (1 / sx): that product lies within 1.5 ulps
// of the correctly rounded quotient, so both round to the same integer
// unless the product sits within 2^-14 of a half-integer (|t| <= 127, so
// 1.5 ulps < 2.3e-5); only there the true division is taken. Adding
// 1.5 * 2^23 rounds to an integer, half to even (rint), and leaves it in
// the low mantissa bits; clamping first is the same as clamping after,
// the bounds being integers. No division, no float-to-int conversion.
__device__ __forceinline__ uint32_t quant1(float v, float sx, float rsx) {
  const float kMagic = 12582912.0f;
  float t = fminf(fmaxf(__fmul_rn(v, rsx), -127.0f), 127.0f);
  float y = __fadd_rn(t, kMagic);
  float frac = __fsub_rn(t, __fsub_rn(y, kMagic));  // t - rint(t), exact, |frac| <= 0.5
  if (fabsf(frac) >= 0.49993896484375f) {                // 0.5 - 2^-14
    y = __fadd_rn(fminf(fmaxf(__fdiv_rn(v, sx), -127.0f), 127.0f), kMagic);
  }
  return __float_as_uint(y);
}

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float sx,
                                           float rsx) {
  uint32_t lo = __byte_perm(quant1(a, sx, rsx), quant1(b, sx, rsx), 0x0040);
  uint32_t hi = __byte_perm(quant1(c, sx, rsx), quant1(d, sx, rsx), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// Eight consecutive K values of one row of A, held in registers between
// their global load and their quantisation. VEC: the eight share one tap
// and are eight channels in a row (C_in % 8 == 0), loaded as 16-byte
// vectors; else each element is gathered on its own (the stem's C_in = 3).
template <typename T, bool VEC> struct Stage;

template <typename T> struct Stage<T, true> {
  static constexpr int kWords = sizeof(T) / 2;  // uint4s per 8 values
  uint4 raw[kWords];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) raw[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(word(raw[e / 4], e % 4));
    } else {
      return from_bits((word(raw[0], e / 2) >> (16 * (e % 2))) & 0xffffu,
                       static_cast<const T*>(nullptr));
    }
  }
};

template <typename T> struct Stage<T, false> {
  float v[8];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
  }
  __device__ __forceinline__ float get(int e) const { return v[e]; }
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ long long out_offset(const Params& p, long long m, int n) {
  if (!p.transpose) return m * p.n + n;
  long long per_image = static_cast<long long>(p.ho) * p.wo;
  long long b = m / per_image;
  int r = static_cast<int>(m - b * per_image);
  int h = r / p.wo, w = r - (r / p.wo) * p.wo;
  int ij = n / p.cout, o = n - ij * p.cout;
  return ((b * 2 * p.ho + 2 * h + (ij >> 1)) * 2 * p.wo + 2 * w + (ij & 1)) * p.cout + o;
}

// the GEMM row of a tile's local row, or -1: consecutive rows from m0
struct RowsOfTile {
  long long m0, m;
  __device__ __forceinline__ long long operator()(int r) const {
    return m0 + r < m ? m0 + r : -1;
  }
};

// One source's sums of the block's tile, dequantised; `part`: 0 the only
// source (bias, one rounding), 1 the pair's first (rounded to T and
// parked in the output), 2 the pair's second (rounded to T, added to the
// parked first in float, rounded again). `rows` maps a local row to its
// GEMM row (-1: none).
template <typename T, int MT, int NT, int WM, int WN, int WARPS_N, typename Rows>
__device__ __forceinline__ void epilogue(const Params& p, const Source& s, int part, int n0,
                                         const int (&acc)[MT][NT][4], const Rows& rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, tig = lane % 4;
  const float sx = *s.sx;
  T* out = static_cast<T*>(p.out);
  long long mrow[MT][2];  // each fragment row's GEMM row, once per tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      mrow[mt][half] = rows(wm * WM + mt * 16 + gid + half * 8);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + wn * WN + nt * 8 + tig * 2;
    if (n >= p.n) continue;
    const bool has1 = n + 1 < p.n, two = p.store2 && has1;
    float scale[2], bias[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int ch = e == 1 && !has1 ? n : n + e;
      if (p.transpose) ch %= p.cout;
      scale[e] = __fmul_rn(sx, __ldg(s.ws + ch));
      if (part == 0 && p.bias != nullptr)
        bias[e] = p.bias_f32 ? __ldg(static_cast<const float*>(p.bias) + ch)
                             : Ty<T>::to_f(static_cast<const T*>(p.bias)[ch]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = mrow[mt][half];
        if (m < 0) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), scale[e]);
          if (part == 0 && p.bias != nullptr) v[e] = __fadd_rn(v[e], bias[e]);
        }
        const long long off = out_offset(p, m, n);
        const long long off1 = two ? off + 1 : (has1 ? out_offset(p, m, n + 1) : off);
        if (part == 2) {
          v[0] = __fadd_rn(Ty<T>::to_f(out[off]), round_to<T>(v[0]));
          v[1] = __fadd_rn(Ty<T>::to_f(out[off1]), round_to<T>(v[1]));
        }
        if (two) {
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float2*>(out + off) = make_float2(v[0], v[1]);
          } else {
            *reinterpret_cast<uint32_t*>(out + off) =
                to_bits(Ty<T>::from_f(v[0])) | (to_bits(Ty<T>::from_f(v[1])) << 16);
          }
        } else {
          out[off] = Ty<T>::from_f(v[0]);
          if (has1) out[off1] = Ty<T>::from_f(v[1]);
        }
      }
  }
}

template <typename T, bool VEC, int BM, int BN, int WARPS_M, int WARPS_N>
struct Conv {
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int A_VECS = BM * kBK / 8 / kThreads;  // 8-byte A vectors per thread
  static constexpr int B_VECS = BN * kBK / 8 / kThreads;  // 8-byte B vectors per thread
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "one block is eight warps");
  static_assert(A_VECS >= 1 && B_VECS >= 1 && MT >= 1 && NT >= 1, "tile too small");

  struct Smem {
    uint8_t a[2][BM][kPitch];
    uint8_t b[2][BN][kPitch];
  };

  // the rows of A this thread loads: image index (-1 past M), top-left tap
  int row_b[A_VECS], row_h[A_VECS], row_w[A_VECS];
  Stage<T, VEC> stage[A_VECS];
  uint2 bstage[B_VECS];
  int acc[MT][NT][4];

  __device__ __forceinline__ void init_rows(const Params& p, long long m0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < A_VECS; ++j) {
      long long m = m0 + tid / (kBK / 8) + j * (kThreads / (kBK / 8));
      if (m < p.m) {
        long long per_image = static_cast<long long>(p.ho) * p.wo;
        int b = static_cast<int>(m / per_image);
        int r = static_cast<int>(m - b * per_image);
        int oh = r / p.wo, ow = r - (r / p.wo) * p.wo;
        row_b[j] = b;
        row_h[j] = oh * p.sh - p.ph;
        row_w[j] = ow * p.sw - p.pw;
      } else {
        row_b[j] = -1;
        row_h[j] = row_w[j] = 0;
      }
    }
  }

  // where this thread's eight K values start: channel c of tap (r, q);
  // moved on by kBK per step without a division (VEC)
  struct Pos {
    int k, c, r, q;
  };

  __device__ __forceinline__ Pos first_pos(const Params& p, const Source& s) const {
    Pos pos{(threadIdx.x % (kBK / 8)) * 8, (threadIdx.x % (kBK / 8)) * 8, 0, 0};
    advance(p, s, pos, 0);
    return pos;
  }

  __device__ __forceinline__ void advance(const Params& p, const Source& s, Pos& pos,
                                          int dk) const {
    pos.k += dk;
    pos.c += dk;
    while (pos.c >= s.c) {
      pos.c -= s.c;
      if (++pos.q == p.kw) {
        pos.q = 0;
        ++pos.r;
      }
    }
  }

  __device__ __forceinline__ void load_a(const Params& p, const Source& s, int k0,
                                         const Pos& pos) {
    const int kv = (threadIdx.x % (kBK / 8)) * 8;
    const T* x = static_cast<const T*>(s.x);
#pragma unroll
    for (int j = 0; j < A_VECS; ++j) {
      stage[j].clear();
      if (row_b[j] < 0) continue;
      if constexpr (VEC) {
        if (pos.k >= s.k) continue;
        int c = pos.c;
        int hi = row_h[j] + pos.r * p.dh, wi = row_w[j] + pos.q * p.dw;
        if (hi < 0 || hi >= p.h || wi < 0 || wi >= p.w) continue;
        const uint4* src = reinterpret_cast<const uint4*>(
            x + ((static_cast<long long>(row_b[j]) * p.h + hi) * p.w + wi) * s.c + c);
#pragma unroll
        for (int i = 0; i < Stage<T, VEC>::kWords; ++i) stage[j].raw[i] = __ldg(src + i);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int k = k0 + kv + e;
          if (k >= s.k) break;
          int tap = k / s.c, c = k - tap * s.c;
          int r = tap / p.kw, q = tap - r * p.kw;
          int hi = row_h[j] + r * p.dh, wi = row_w[j] + q * p.dw;
          if (hi < 0 || hi >= p.h || wi < 0 || wi >= p.w) continue;
          stage[j].v[e] = Ty<T>::to_f(
              x[((static_cast<long long>(row_b[j]) * p.h + hi) * p.w + wi) * s.c + c]);
        }
      }
    }
  }

  __device__ __forceinline__ void load_b(const Source& s, int n0, int k0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < B_VECS; ++j) {
      int i = tid + j * kThreads;
      int n = n0 + i / (kBK / 8), k = k0 + (i % (kBK / 8)) * 8;
      bstage[j] = make_uint2(0, 0);
      if (n < s.n_rows && k < s.ldw)
        bstage[j] = __ldg(reinterpret_cast<const uint2*>(s.w + static_cast<long long>(n) * s.ldw + k));
    }
  }

  __device__ __forceinline__ void store_stage(Smem& sm, int buf, float sx, float rsx) {
    const int tid = threadIdx.x;
    const int kv = (tid % (kBK / 8)) * 8;
#pragma unroll
    for (int j = 0; j < A_VECS; ++j) {
      int row = tid / (kBK / 8) + j * (kThreads / (kBK / 8));
      const Stage<T, VEC>& st = stage[j];
      uint2 q;
      q.x = quant4(st.get(0), st.get(1), st.get(2), st.get(3), sx, rsx);
      q.y = quant4(st.get(4), st.get(5), st.get(6), st.get(7), sx, rsx);
      *reinterpret_cast<uint2*>(&sm.a[buf][row][kv]) = q;
    }
#pragma unroll
    for (int j = 0; j < B_VECS; ++j) {
      int i = tid + j * kThreads;
      *reinterpret_cast<uint2*>(&sm.b[buf][i / (kBK / 8)][(i % (kBK / 8)) * 8]) = bstage[j];
    }
  }

  __device__ __forceinline__ void compute(const Smem& sm, int buf) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        int r = wm * WM + mt * 16 + gid;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][r][ks + tig * 4]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][r + 8][ks + tig * 4]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][r][ks + 16 + tig * 4]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int r = wn * WN + nt * 8 + gid;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&sm.b[buf][r][ks + tig * 4]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&sm.b[buf][r][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // acc = sum over this source's K of q(A) * W, for the block's tile
  __device__ __forceinline__ void mainloop(const Params& p, const Source& s, Smem& sm,
                                           int n0, long long m0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    const float sx = *s.sx, rsx = __frcp_rn(sx);
    const int steps = (s.k + kBK - 1) / kBK;
    Pos pos = first_pos(p, s);
    load_a(p, s, 0, pos);
    load_b(s, n0, 0);
    store_stage(sm, 0, sx, rsx);
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      const int buf = step & 1;
      const bool more = step + 1 < steps;
      if (more) {  // the next step's loads fly while the tensor cores work
        if constexpr (VEC) advance(p, s, pos, kBK);
        load_a(p, s, (step + 1) * kBK, pos);
        load_b(s, n0, (step + 1) * kBK);
      }
      compute(sm, buf);
      if (more) store_stage(sm, buf ^ 1, sx, rsx);
      __syncthreads();
    }
  }

  __device__ void run(const Params& p) {
    __shared__ __align__(16) Smem sm;
    const int n_tiles = (p.n + BN - 1) / BN;
    const long long tile = blockIdx.x;
    const int n0 = static_cast<int>(tile % n_tiles) * BN;  // N fastest: blocks in
    const long long m0 = (tile / n_tiles) * BM;             // flight share A rows
    init_rows(p, m0);
    const RowsOfTile rows{m0, p.m};
    mainloop(p, p.src[0], sm, n0, m0);
    epilogue<T, MT, NT, WM, WN, WARPS_N>(p, p.src[0], p.nsrc == 2 ? 1 : 0, n0, acc, rows);
    if (p.nsrc == 2) {  // each thread reads back only what it wrote
      mainloop(p, p.src[1], sm, n0, m0);
      epilogue<T, MT, NT, WM, WN, WARPS_N>(p, p.src[1], 2, n0, acc, rows);
    }
  }
};

// The halo path (3x3, stride 1, dilation 1, C_in % 32 == 0):
// a block computes a tile of tr x tc output pixels of one image. For each
// chunk of 32 input channels it loads the tile's halo, (tr + 2) x (tc + 2)
// pixels, and quantises each element once into shared memory (an element
// is quantised ~1.4 times per N tile instead of 9 times),
// while cp.async brings the chunk's weight tiles of all taps; after one
// barrier every tap's products run back to back, their fragments read
// with ldmatrix (A at the tap's offset into the halo). Two barriers per
// chunk; the two blocks an SM holds overlap one's loads with the other's
// products (three where the N tile is at most 64 wide). Dynamic shared
// memory (up to 68 KB): the attribute is set once per device by
// octave_int8_conv_init, at load time.
constexpr int kHaloMax = 272;        // halo pixels: 4 x 66 (tc = 64) is the largest the host picks
constexpr int kHaloCK = 32;          // input channels per chunk: one m16n8k32 step per tap
constexpr int kHaloPitch = kHaloCK + 16;  // 48 bytes: 16-byte rows for ldmatrix, no conflicts
constexpr int kTapsMax = 9;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zeros where `bytes` is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

template <typename T, int BN, int WARPS_M, int WARPS_N>
struct HaloConv {
  static constexpr int BM = 128;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int HALO_BYTES = kHaloMax * kHaloPitch;
  static constexpr int SMEM = HALO_BYTES + kTapsMax * BN * kHaloPitch;
  static_assert(WARPS_M * WARPS_N * 32 == kThreads && MT >= 1 && NT % 2 == 0, "tile");

  int acc[MT][NT][4];
  int hpl[MT];  // halo pixel (tap (0, 0)) of the row this lane addresses for ldmatrix

  // the chunk's weight tiles, (tap, n, 32 channels), by cp.async
  __device__ __forceinline__ void load_b(const Source& s, uint8_t* bsm, int n0, int c0) {
    const int total = kTapsMax * BN * 2;  // 16-byte pieces
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int t = i / (BN * 2), rem = i - t * (BN * 2);
      const int n = rem / 2, kk = (rem % 2) * 16;
      const bool ok = n0 + n < s.n_rows;
      const int8_t* src =
          ok ? s.w + static_cast<long long>(n0 + n) * s.ldw + t * s.c + c0 + kk : s.w;
      cp_async16(smem_addr(bsm + (t * BN + n) * kHaloPitch + kk), src, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // the halo of channels [c0, c0 + 32) of image b, quantised into smem
  __device__ __forceinline__ void load_halo(const Params& p, const Source& s, uint8_t* halo,
                                            int b, int ih0, int iw0, int c0, float sx,
                                            float rsx) {
    const int hw = p.tc + 2;
    const int nvec = (p.tr + 2) * hw * (kHaloCK / 8);
    const float rhw = 1.0f / hw;  // px / hw as a multiply: px < 512, hw < 128
    const T* x = static_cast<const T*>(s.x);
    for (int base = 0; base < nvec; base += 4 * kThreads) {
      Stage<T, true> st[4];
      int dst[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // four loads in flight before the first store
        const int v = base + u * kThreads + threadIdx.x;
        st[u].clear();
        dst[u] = -1;
        if (v < nvec) {
          const int px = v / (kHaloCK / 8), cv = (v % (kHaloCK / 8)) * 8;
          dst[u] = px * kHaloPitch + cv;
          const int hy = static_cast<int>((px + 0.5f) * rhw), hx = px - hy * hw;
          const int ih = ih0 + hy, iw = iw0 + hx;
          if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w) {
            const uint4* src = reinterpret_cast<const uint4*>(
                x + ((static_cast<long long>(b) * p.h + ih) * p.w + iw) * s.c + c0 + cv);
#pragma unroll
            for (int i = 0; i < Stage<T, true>::kWords; ++i) st[u].raw[i] = __ldg(src + i);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (dst[u] < 0) continue;
        uint2 q;
        q.x = quant4(st[u].get(0), st[u].get(1), st[u].get(2), st[u].get(3), sx, rsx);
        q.y = quant4(st[u].get(4), st[u].get(5), st[u].get(6), st[u].get(7), sx, rsx);
        *reinterpret_cast<uint2*>(halo + dst[u]) = q;
      }
    }
  }

  // one tap's products: A from the halo at the tap's offset, B its tile
  __device__ __forceinline__ void compute(const uint8_t* halo, const uint8_t* bsm, int tap,
                                          int tap_off) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wn = warp % WARPS_N;
    uint32_t a[MT][4], b[NT][2];
    const int akoff = (lane / 16) * 16;  // matrices 2, 3: k 16-31
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], smem_addr(halo + (hpl[mt] + tap_off) * kHaloPitch + akoff));
    // B: matrices (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
    const int bn = wn * WN + ((lane / 16) * 8) + lane % 8, bkoff = ((lane / 8) % 2) * 16;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, smem_addr(bsm + (tap * BN + bn + nt * 8) * kHaloPitch + bkoff));
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
  }

  __device__ __forceinline__ void mainloop(const Params& p, const Source& s, uint8_t* halo,
                                           uint8_t* bsm, int n0, int b, int ih0, int iw0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    const float sx = *s.sx, rsx = __frcp_rn(sx);
    const int hw = p.tc + 2;
    for (int c0 = 0; c0 < s.c; c0 += kHaloCK) {
      __syncthreads();  // the last chunk's readers are done
      load_b(s, bsm, n0, c0);
      load_halo(p, s, halo, b, ih0, iw0, c0, sx, rsx);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 9; ++t) compute(halo, bsm, t, (t / 3) * hw + t % 3);
    }
  }

  __device__ void run(const Params& p) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* halo = smem;
    uint8_t* bsm = smem + HALO_BYTES;
    const int n_tiles = (p.n + BN - 1) / BN;
    long long t = blockIdx.x;
    const int n0 = static_cast<int>(t % n_tiles) * BN;  // N fastest: blocks in flight
    t /= n_tiles;                                       // share the halo
    const int ct = static_cast<int>(t % p.col_tiles);
    t /= p.col_tiles;
    const int rt = static_cast<int>(t % p.row_tiles);
    const int b = static_cast<int>(t / p.row_tiles);
    const int oh0 = rt * p.tr, ow0 = ct * p.tc;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / WARPS_N;
    const int hw = p.tc + p.kw - 1;
    // ldmatrix rows: lane l addresses row (l % 8) + 8 * ((l / 8) % 2) of its m16 tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm * WM + mt * 16 + lane % 8 + ((lane / 8) % 2) * 8;
      hpl[mt] = r < p.tr * p.tc ? (r / p.tc) * hw + r % p.tc : 0;
    }
    const HaloRows rows{p, b, oh0, ow0};
    mainloop(p, p.src[0], halo, bsm, n0, b, oh0 - p.ph, ow0 - p.pw);
    epilogue<T, MT, NT, WM, WN, WARPS_N>(p, p.src[0], p.nsrc == 2 ? 1 : 0, n0, acc, rows);
    if (p.nsrc == 2) {
      mainloop(p, p.src[1], halo, bsm, n0, b, oh0 - p.ph, ow0 - p.pw);
      epilogue<T, MT, NT, WM, WN, WARPS_N>(p, p.src[1], 2, n0, acc, rows);
    }
  }

  struct HaloRows {
    const Params& p;
    int b, oh0, ow0;
    __device__ __forceinline__ long long operator()(int r) const {
      if (r >= p.tr * p.tc) return -1;
      const int oh = oh0 + r / p.tc, ow = ow0 + r % p.tc;
      if (oh >= p.ho || ow >= p.wo) return -1;
      return (static_cast<long long>(b) * p.ho + oh) * p.wo + ow;
    }
  };
};

// narrow tiles keep few accumulators: three blocks per SM hide more latency
template <typename T, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 3 : 2)
    int8_conv_halo_kernel(const Params p) {
  HaloConv<T, BN, WARPS_M, WARPS_N> conv;
  conv.run(p);
}

template <typename T, bool VEC, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(kThreads, 2) int8_conv_kernel(const Params p) {
  Conv<T, VEC, BM, BN, WARPS_M, WARPS_N> conv;
  conv.run(p);
}

template <typename T, bool VEC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // tile shapes by the GEMM's width: narrow convs take taller tiles
  if (p.n <= 32) {
    long long blocks = (p.m + 255) / 256 * ((p.n + 31) / 32);
    int8_conv_kernel<T, VEC, 256, 32, 8, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  } else if (p.n <= 64) {
    long long blocks = (p.m + 127) / 128 * ((p.n + 63) / 64);
    int8_conv_kernel<T, VEC, 128, 64, 4, 2><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  } else {
    long long blocks = (p.m + 127) / 128 * ((p.n + 127) / 128);
    int8_conv_kernel<T, VEC, 128, 128, 2, 4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// the halo kernels of one dtype, by the GEMM's width
#define OCTAVE_HALO_KERNELS(T)                                   \
  X(T, 32, 8, 1) X(T, 64, 4, 2) X(T, 128, 2, 4)

template <typename T>
cudaError_t launch_halo(const Params& p, cudaStream_t stream) {
  const long long tiles = p.m / (static_cast<long long>(p.ho) * p.wo) * p.row_tiles *
                          p.col_tiles;
#define X(T_, BN, WM_, WN_)                                                               \
  if (p.n <= BN || BN == 128) {                                                          \
    using K = HaloConv<T_, BN, WM_, WN_>;                                                \
    const unsigned blocks = static_cast<unsigned>(tiles * ((p.n + BN - 1) / BN));        \
    int8_conv_halo_kernel<T_, BN, WM_, WN_><<<blocks, kThreads, K::SMEM, stream>>>(p);   \
    return cudaGetLastError();                                                           \
  }
  OCTAVE_HALO_KERNELS(T)
#undef X
  return cudaErrorInvalidValue;
}

// Let the halo kernels of one dtype use their dynamic shared memory on the
// current device: once per device, at load time, never inside a capture.
template <typename T>
cudaError_t init_dtype() {
#define X(T_, BN, WM_, WN_)                                                               \
  {                                                                                      \
    cudaError_t e = cudaFuncSetAttribute(int8_conv_halo_kernel<T_, BN, WM_, WN_>,         \
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                                         HaloConv<T_, BN, WM_, WN_>::SMEM);              \
    if (e != cudaSuccess) return e;                                                      \
  }
  OCTAVE_HALO_KERNELS(T)
#undef X
  return cudaSuccess;
}

// The wide halo path (int8_conv_sm90.cuh, HaloConvSm90): a tile is 128
// positions of a grid of the images with one pad row and one pad column
// shared between neighbours, computed by a producer warpgroup and two
// consumer warpgroups around two rings in dynamic shared memory: the nine
// taps' weights of a stage (`stages` of them, 2-4) and its quantised halo
// (kSm90AStages).
constexpr int kSm90BM = 128;         // grid positions of a tile: 64 per consumer warpgroup
constexpr int kSm90CK = 32;          // channels of a stage: one k32 step per tap
constexpr int kSm90MaxStages = 4;
constexpr int kSm90AStages = 4;      // quantised halos: the producer quantises ahead of the weights
constexpr int kSm90Smem = 232448;    // the most dynamic shared memory a block may have
constexpr int kSm90OutPitch = 80;    // bytes of a staged output row: 64 and 16 apart

__host__ __device__ constexpr int sm90_b_stage(int bn) { return 9 * bn * kSm90CK; }

// A block's dynamic shared memory: alignment slack, the stages' weights,
// two raw halos (`raw` bytes each), the quantised halos, a tile's column
// scales and biases, the consumer warps' staged output rows, the barriers.
__host__ __device__ constexpr int sm90_smem(int bn, int stages, int halo, int raw) {
  return 1024 + stages * sm90_b_stage(bn) + kSm90AStages * 2 * halo * 16 + 2 * raw +
         2 * 256 * 4 + 8 * 16 * kSm90OutPitch + (2 * stages + 2 * kSm90AStages + 2) * 8;
}

// How the wide halo path would run a conv that the halo path takes: the
// grid's strips (images wider than 20 columns are cut into strips of about
// 19 columns, each row of a strip with its own halo column on either side,
// so that a tile's halo stays ~1.5 positions per output whatever the
// width), their width and the grid's row pitch, the N tile (256 where N is
// a multiple of it and the rings fit, else 128), the weights' stages that
// fit (two to kSm90MaxStages), the halo, the raw halo's grid rows and their
// pitch in shared memory (a TMA box each, padded to the swizzle's period),
// the tiles and the card's SMs; bn == 0 where it does not apply (N < 128
// or not a multiple of 8, padding other than 1).
struct Sm90Plan {
  int bn, stages, halo, rows, row_bytes, tiles, sms, strips, wc, lead, pitch;
};

inline Sm90Plan plan_sm90(const Params& p, int elem) {
  Sm90Plan plan{};
  if (p.n < 128 || p.n % 8 != 0 || p.ph != 1 || p.pw != 1) return plan;
  plan.strips = (p.w + 19) / 20;
  plan.wc = (p.w + plan.strips - 1) / plan.strips;
  plan.lead = plan.strips > 1 ? 1 : 0;  // one strip: the pad column shared by neighbouring rows
  plan.pitch = plan.wc + 1 + plan.lead;
  const long long grid =
      p.m / (static_cast<long long>(p.h) * p.w) * plan.strips * (p.h + 1) * plan.pitch;
  if (grid > (1LL << 30)) return plan;  // grid positions in an int
  const int span = kSm90BM + 2 * plan.pitch + 2;
  const int period = elem == 4 ? 1024 : 512;  // of the raw halo's 128- or 64-byte swizzle
  plan.halo = (span + 7) / 8 * 8;
  plan.rows = (plan.halo - 1) / plan.pitch + 2;  // the grid rows any halo of this length touches
  plan.row_bytes = (plan.pitch * kSm90CK * elem + period - 1) / period * period;
  for (int bn = 256; bn >= 128 && plan.bn == 0; bn -= 128) {
    if (bn == 256 && p.n % 256 != 0) continue;
    int stages = kSm90MaxStages;
    while (stages >= 2 &&
           sm90_smem(bn, stages, plan.halo, plan.rows * plan.row_bytes) > kSm90Smem)
      --stages;
    if (stages >= 2) {
      plan.bn = bn;
      plan.stages = stages;
    }
  }
  if (plan.bn == 0) return plan;
  plan.tiles = static_cast<int>((grid + kSm90BM - 1) / kSm90BM * ((p.n + plan.bn - 1) / plan.bn));
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&plan.sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    plan.bn = 0;
  return plan;
}

// The halo kernels of each dtype live in a translation unit of their own
// (int8_conv_halo_{f32,bf16,f16}.cu), the wide halo kernels in another
// (int8_conv_sm90_{f32,bf16,f16}.cu), the per-tap ones in a third
// (int8_conv_{f32,bf16,f16}.cu), so that nvcc compiles the nine in parallel.
cudaError_t launch_halo_of(const Params& p, cudaStream_t stream, const float*);
cudaError_t launch_halo_of(const Params& p, cudaStream_t stream, const __nv_bfloat16*);
cudaError_t launch_halo_of(const Params& p, cudaStream_t stream, const __half*);
cudaError_t launch_sm90_of(const Params& p, const Sm90Plan& plan, cudaStream_t stream,
                           const float*);
cudaError_t launch_sm90_of(const Params& p, const Sm90Plan& plan, cudaStream_t stream,
                           const __nv_bfloat16*);
cudaError_t launch_sm90_of(const Params& p, const Sm90Plan& plan, cudaStream_t stream,
                           const __half*);
cudaError_t init_sm90_f32();
cudaError_t init_sm90_bf16();
cudaError_t init_sm90_f16();
// cuTensorMapEncodeTiled, as octave_int8_conv_init fetched it, or null
void* tensor_map_encoder();

// The paths, as the entry point reports them (and takes them, forced)
constexpr int kPathTap = 0, kPathHalo = 1, kPathWgmma = 2;

// The wide halo path where it applies, the halo path (see HaloConv) where
// that applies, else the per-tap one. The wide path has no crossover by
// size: phase 15's table (PERF.md) finds it ahead of the halo kernel at
// every site of the decoder from B = 1 (16 tiles, 1.26x) to B = 256 (2.05-
// 2.63x). `force` >= 0 takes that path, or fails where it does not apply
// (measurement).
template <typename T>
cudaError_t launch_dtype(Params p, bool vec, int force, int* path, cudaStream_t stream) {
  bool halo = vec && !p.transpose && p.sh == 1 && p.sw == 1 && p.dh == 1 && p.dw == 1 &&
              p.kh == 3 && p.kw == 3;
  for (int i = 0; i < p.nsrc; ++i)  // whole chunks; 16-byte weight rows for cp.async
    halo = halo && p.src[i].c % kHaloCK == 0 && p.src[i].ldw % 16 == 0 &&
           reinterpret_cast<uintptr_t>(p.src[i].w) % 16 == 0;
  if (halo) {
    p.tc = p.wo <= 64 ? p.wo : 16;
    p.tr = 128 / p.tc;
    halo = (p.tr + p.kh - 1) * (p.tc + p.kw - 1) <= kHaloMax;
  }
  const Sm90Plan plan = halo ? plan_sm90(p, sizeof(T)) : Sm90Plan{};
  const int take = force >= 0 ? force : plan.bn != 0 ? kPathWgmma : halo ? kPathHalo : kPathTap;
  if (take > kPathWgmma || (take == kPathHalo && !halo) || (take == kPathWgmma && plan.bn == 0))
    return cudaErrorInvalidValue;
  *path = take;
  if (take == kPathWgmma) return launch_sm90_of(p, plan, stream, static_cast<const T*>(nullptr));
  if (take == kPathHalo) {
    p.row_tiles = (p.ho + p.tr - 1) / p.tr;
    p.col_tiles = (p.wo + p.tc - 1) / p.tc;
    return launch_halo_of(p, stream, static_cast<const T*>(nullptr));
  }
  return vec ? launch<T, true>(p, stream) : launch<T, false>(p, stream);
}

cudaError_t launch_f32(const Params& p, bool vec, int force, int* path, cudaStream_t stream);
cudaError_t launch_bf16(const Params& p, bool vec, int force, int* path, cudaStream_t stream);
cudaError_t launch_f16(const Params& p, bool vec, int force, int* path, cudaStream_t stream);
cudaError_t init_f32();
cudaError_t init_bf16();
cudaError_t init_f16();

}  // namespace octave



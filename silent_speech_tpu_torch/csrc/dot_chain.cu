// Chained-dot rate probe for Hopper (sm_90a): for each of `steps` grid
// steps, a seed from the sum of the step's (8, 128) uint8 block, then a
// serial chain of DEPTH = 14 products y <- y W, y (384, K), W (K, K),
// K in {384, 512}, and one f32 value, the sum of y[0, 0:128], written over
// the step's (8, 128) output block.
//
// Replaces scripts/probe_int8.py::_kernel (:57, built by ::build, the
// pallas_call at :97). Modes, as there:
//   f32    y0 = f32(seed) * 1e-6; y <- y W in f32 (3xTF32 on wgmma m64nNk8
//          tf32 -> f32, namespace chain32)
//   bf16   y0 = bf16(f32(seed) * 1e-6); y <- bf16(y W), each product's f32
//          sum rounded to bf16 (wgmma m64nNk16 bf16 -> f32, namespace
//          chain16)
//   int8   y0 = s8(seed & 63); y <- s8(acc >> 7), acc = y W in s32 (wgmma
//          m64nNk32 s8 -> s32, namespace chain8), the arithmetic shift
//          then a wrap modulo 256 as XLA's convert does (not a saturation)
//   int8i  acc = sum over d < 14 of (base + d) W in s32, base = s8(seed & 63):
//          14 independent s8 products, no re-narrowing
// The int modes' output sum is taken exactly (int64) and rounded once to
// f32. The TPU kernel's W is a VMEM scratch that is never written, so its
// output is undefined; this kernel takes W as an input.
//
// The TPU kernel keeps the whole (384, K) chain state in VMEM (576-768 KB
// in f32), more than a block's 227 KB of shared memory. y <- y W acts row
// by row, so here a block (or a cluster of blocks, or a warpgroup) owns a
// tile of TM = 64 rows of one step through all 14 products, in shared
// memory: every row of every step is still computed.
//
// What bounds it: the multiply-adds, steps * 14 * 384 * K^2 (203 G at
// K=384, 361 G at K=512 for 256 steps): 1.750 / 3.110 ms at the f32 FMAs
// and 3xTF32 together (232 TFLOP/s), 0.41 / 0.73 ms bf16, 0.205 / 0.365 ms
// int8. A 64-row tile re-reads the whole of W for every product: at the
// bf16 peak one SM would draw 117 GB/s of W from L2, 15.5 TB/s for 132
// SMs; in f32, W's hi and lo planes are 4x bf16's bytes a multiply-add.
//
// int8, int8i (namespace chain8): W^T in s8 stays in shared memory for
// the life of a persistent block, brought from L2 once by TMA (packed by
// ops/cuda_dot_chain.pack_weights in wgmma's 128-byte swizzle, 128 k an
// atom): all of it at K=384 (147,456 B), at K=512 (256 KB, more than a
// block holds) half of its rows in each block of a cluster of 2 (131,072
// B), each block computing half of the columns. Beside it, one 64-row y
// tile (s8, the same swizzle) for each of the block's two warpgroups, which
// walk the (step, tile) items on their own: a product is one group of
// wgmma m64n192k32 (two a k32 step, 192 s32 sums a thread) or m64n256k32
// (one, 128 sums) s8 -> s32 with A (y) and B (W^T) from shared memory;
// then the warpgroup narrows its sums into y (int8: (acc >> 7) & 0xff,
// stored into the swizzled A layout) or refills y with the next constant
// (int8i, whose sums go on in the same registers: every product's 64 x K x
// K multiply-adds run), between two barriers of its own (named barriers:
// no block-wide barrier between products), so that one warpgroup's tail
// runs under the other's wgmmas. At K=512 (int8) the blocks of a pair
// exchange their new halves of y: one bulk copy from shared memory into the
// other block's y (cp.async.bulk shared::cluster), completing on that
// block's full barrier, once both warpgroups have arrived on each other's
// empty barrier (their reads of y, and the previous copy, are done). W
// comes from L2 once a block (about 20 MB a call), not once a product of
// a tile (3.2 / 5.6 GB at 256 steps).
//
// f32 (namespace chain32): a 64-row y tile in f32 is 96 KB at K=384 and
// 128 KB at K=512, and one 32-k chunk of both of W^T's planes at full width
// 96 / 128 KB, so a block cannot hold y and a ring of whole-width chunks.
// The tile goes to a cluster of 2 blocks, each holding all of y and
// computing half of the columns of every product, its two warpgroups a
// quarter each (wgmma m64n96k8 / m64n128k8 tf32): W^T's hi / lo planes,
// packed once (ops/cuda_dot_chain.pack_weights: chunk c, plane, n, 16-byte
// unit u of W^T[n, 32 c + 4 u ...] at u ^ (n % 8)), come by TMA bulk copies
// that thread 0 issues into a ring of mbarrier units, up to a ring ahead,
// across products and items: 2 units of a whole chunk of the block's rows
// (48 KB) at K=384, 3 of one plane (32 KB) at K=512. Each warp loads its 16
// rows of y's chunk and splits them in registers (wgmma's A; at K=384 the
// next chunk's while this one's wgmmas run), then runs the chunk's 12
// wgmmas (lo*hi, hi*lo, hi*hi a k8 step) once its planes have landed. They
// sum from zero and are added into the product's f32 total (the tensor
// cores' accumulation truncates: one sum over K = 512 would reach 7.6e-6
// of a product's partial sums, against the 1e-5 bar over 14 products).
// A block takes a product's chunks from its own half of y on: after a
// product it writes its new half into its own y and runs the next
// product's first half on it, while the other block finishes; halfway it
// copies its half into the other block's y through distributed shared
// memory, between two cluster barriers, then runs the other half. y is
// kept with row r's column c at c ^ 4 (r % 8): conflict-free fragment
// loads with no padding. Persistent clusters walk the (step, tile) items.
// Every output is summed in a fixed order: repeated launches give the same
// bits. W's planes come from L2 for every product of every tile (25 GB a
// call at K=384, 45 GB at K=512), which at about 5 TB/s takes more than
// the multiply-adds on the tensor cores; dot_chain_f32_stop times the
// parts (one TF32 pass, no exchange, no feed).
//
// bf16 (namespace chain16): the blocks of a step form clusters of C (1,
// 2, 3 or 6, dividing the 6 tiles; dot_chain_plan takes the largest whose
// clusters the card runs on 15/16 of its SMs) that share each W chunk: a
// chunk is 64 k-columns of W^T for one half of the n (24 KB at K=384, 32
// KB at K=512), packed contiguous in wgmma's 128-byte swizzle
// (ops/cuda_dot_chain.pack_weights), and each block's copy warp brings its
// 1/C of the chunk's rows from L2 into the same stage of every block of
// the cluster by one TMA bulk copy (cp.async.bulk ... multicast::cluster),
// so L2 serves W once a cluster: a ring of 7 (K=384) or 5 (K=512) stages
// beside y, each with a full mbarrier (the chunk's bytes) and an empty one
// (the 4 warps of that half's warpgroup in each of the C blocks arrive,
// across the cluster), so that the copies run up to a ring ahead of the
// MMAs, across products. Two warpgroups each take all 64 rows by one half
// of the n: one wgmma m64n(K/2)k16 bf16 a k16 step, A (y) and B (the
// chunk) read from shared memory in the 128-byte swizzle (y: 64 rows x 128
// bytes an atom of 64 k), f32 sums in k order, a stage freed once the next
// chunk's wgmmas are in flight. After a product the warpgroups round their
// sums to bf16 into y between two barriers of their own, then fence y's
// writes for the wgmmas' reads. Repeated calls, and every cluster size,
// give the same bits. What it does not hide is each product's tail: the
// rounding of y between two barriers, which no wgmma overlaps (not timed
// apart; PERF.md gives its times). Its CPU tests are the geometry
// and the chunk layout (tests/test_torch_dot_chain_bf16.py) and the
// chain's arithmetic against the Pallas kernel
// (tests/test_torch_rate_probes.py); the f32 chain's arithmetic and
// geometry are tests/test_torch_mr_dc_tc.py's; the s8 chains' layouts,
// geometry and item walk (a numpy model of the index maps, through exact
// integer products) tests/test_torch_dc_s8_tc.py's.

// A check instantiation (moments != nullptr) also writes the three moments
// of each block's final y values (the sum, the sum of squares and the sum
// weighted by i % 31, i = row * K + col in the step's (384, K) y): doubles
// for f32 / bf16, int64 sums modulo 2^64 for the int modes (exact, so any
// order gives the same bits: each warp adds its share atomically), one
// triple a (step, tile), and in f32 one a (step, tile, block of the
// cluster). In bf16 it also
// writes the trace: row 13 * tile % 64 of the block's tile after each of
// the 14 products, the bf16 values the next product reads, so that each
// product's rounding can be held against the product of the block's own
// previous row. The moments cannot tell that: a chain that keeps y in f32
// ends about as far from the plain version as two sound chains whose f32
// sums once round a value to its other bf16 neighbour.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int M = 384, DEPTH = 14, XBLOCK = 8 * 128;
constexpr int TM = 64, TILES = M / TM;
constexpr int THREADS = 256, NWARPS = THREADS / 32;
constexpr int POS_PERIOD = 31, ROW0 = 128;
constexpr int TRACE_STRIDE = 13;  // the traced row of tile t: 13 t % TM

enum Mode { F32 = 0, BF16 = 1, INT8 = 2, INT8I = 3 };

// ------------------------------------------- thread block clusters, TMA
__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
// one arrival on the barrier at `bar` in block `cta` of the cluster (the
// stage's reads are done: their values are in the MMAs' registers)
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta) : "memory");
}
// `bytes` from global to shared memory by the TMA unit, completing on the
// barrier at the same offset; multicast: into every block of `mask`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}
// the rank's shared-memory address `addr` in block `cta` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(cta));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}
// one arrival on a barrier of this block
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// sum over the block, returned to every thread; red holds NWARPS + 1
template <typename T>
__device__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = 0;
    for (int w = 0; w < NWARPS; ++w) s += red[w];
    red[NWARPS] = s;
  }
  __syncthreads();
  const T s = red[NWARPS];
  __syncthreads();
  return s;
}

// the sum of the step's 1,024 bytes of x, in s32, to every thread (256)
__device__ __forceinline__ int step_seed(const uint8_t* __restrict__ x,
                                         int step, int* red) {
  const uint32_t word =
      reinterpret_cast<const uint32_t*>(x + (size_t)step * XBLOCK)[threadIdx.x];
  return block_sum<int>((int)((word & 0xffu) + ((word >> 8) & 0xffu) +
                              ((word >> 16) & 0xffu) + (word >> 24)),
                        red);
}

// ------------------------------------------------------- int8, int8i
// The s8 chains on wgmma with W^T resident in shared memory (modes 2, 3;
// see the notes at the top).
namespace chain8 {

constexpr int WGS = 2;                 // warpgroups a block, an item each
constexpr int THREADS = 128 * WGS;
constexpr int KA = 128;                // k of a swizzle atom: 128 bytes a row
constexpr int Y_ATOM = TM * KA;        // y's bytes of one atom
constexpr int ALIGN = 1024;            // the swizzle's period: planes on it
// a block's dynamic shared memory, beside its static 1 KB or less
constexpr int SMEM_BUDGET = 232448 - 1024;

// K's geometry: clusters of C blocks, block `rank` holding W^T's COLS rows
// [rank COLS, rank COLS + COLS) (the columns of y W it computes) for every
// atom of 128 k, each atom a PLANE of COLS rows x 128 bytes in the
// 128-byte swizzle; then one y tile (TM x K s8, ATOMS atoms of TM rows in
// the same swizzle) a warpgroup. A warpgroup's sums are 64 x COLS s32:
// PARTS wgmmas m64nWNk32 a k32 step, NACC registers a thread. At K=384 all
// of W^T fits (C 1, two n192 wgmmas); at K=512 it does not, and each block
// of a pair holds half (C 2, one n256 wgmma), the blocks swapping their
// new halves of y (OWN atoms each) after every int8 product.
template <int K>
struct Geo {
  static constexpr int C = K == 384 ? 1 : 2;
  static constexpr int COLS = K / C, WN = K / 2, PARTS = COLS / WN;
  static constexpr int ATOMS = K / KA, OWN = ATOMS / C;
  static constexpr int PLANE = COLS * KA, W_BYTES = ATOMS * PLANE;
  static constexpr int Y_BYTES = TM * K;
  static constexpr int SMEM = ALIGN + W_BYTES + WGS * Y_BYTES;
  static constexpr int NACC = COLS / 2;
  static_assert(K % KA == 0 && COLS % KA == 0 && (WN == 192 || WN == 256) &&
                    PLANE % ALIGN == 0 && Y_ATOM % ALIGN == 0 &&
                    SMEM <= SMEM_BUDGET,
                "whole atoms, wgmma widths, aligned planes, one block an SM");
};

// this warp's share of d (64 x 192 s32) = A B (scale_d 0) or d + A B:
// wgmma m64n192k32 s8, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n192(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// this warp's share of d (64 x 256 s32) = A B (scale_d 0) or d + A B:
// wgmma m64n256k32 s8, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,"
      "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int WN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (WN == 192)
    wgmma_s8_n192(d, da, db, scale_d);
  else
    wgmma_s8_n256(d, da, db, scale_d);
}

// keeps the s32 sums live and in place across the asynchronous wgmmas
template <int N>
__device__ __forceinline__ void fence_sums(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the 128 threads of warpgroup h alone
__device__ __forceinline__ void wg_sync(int h) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + h) : "memory");
}

// `bytes` from this block's shared memory into a block of the cluster
// (dst, bar: shared::cluster addresses there), by the TMA unit, completing
// on that block's barrier
__device__ __forceinline__ void bulk_copy_s2s(uint32_t dst, uint32_t src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// grid (C x clusters), clusters of C along x, WGS warpgroups a block:
// warpgroup h of cluster i takes slot i WGS + h and walks the items (step,
// tile) = slot, slot + slots, ... (item = step TILES + tile), each block of
// the cluster computing its COLS columns of every product of the tile's 64
// rows; the blocks' warpgroups h run the same items. Thread 0 brings the
// block's W^T planes once, by TMA. A product is one group of wgmmas over
// all of y and the planes, its sums in registers; then (int8) the
// warpgroup narrows them into its y, between two barriers of its own, or
// (int8i) fills y with the next constant. At C 2 (int8) it also sends its
// new half to the other block's y by one bulk copy, completing on that
// block's `full` barrier, once that block's warps have arrived on this
// one's `empty` barrier (they are done reading the old y; this block's
// previous copy has landed); a product's wgmmas on its own half of y are
// in flight before it waits for the other half.
template <int MODE, int K, bool CHECK>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
             float* __restrict__ out,
             unsigned long long* __restrict__ moments,
             float* __restrict__ sink, int sink_at, int steps) {
  static_assert(MODE == INT8 || MODE == INT8I, "the s8 modes");
  using G = Geo<K>;
  using Mom = unsigned long long;
  constexpr int C = G::C;
  constexpr bool SWAP = C > 1 && MODE == INT8;  // halves of y swapped
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ws = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                            (ALIGN - 1));
  // W's barrier, then each warpgroup's full and empty barriers
  __shared__ __align__(8) uint64_t bars[1 + 2 * WGS];
  __shared__ int redi[WGS][4];

  const int tid = threadIdx.x, h = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, wl = wt >> 5, g = lane >> 2, t4 = lane & 3;
  const uint32_t rank = C > 1 ? cta_rank() : 0, peer = rank ^ 1;
  uint8_t* ys = ws + G::W_BYTES + h * G::Y_BYTES;
  const uint32_t w_u32 = smem_u32(ws), y_u32 = smem_u32(ys);
  const uint32_t wbar = smem_u32(&bars[0]);
  const uint32_t full = smem_u32(&bars[1 + h]);
  const uint32_t empty = smem_u32(&bars[1 + WGS + h]);
  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < WGS; ++i) {
      mbar_init(smem_u32(&bars[1 + i]), 1);        // the block's own arrival
      mbar_init(smem_u32(&bars[1 + WGS + i]), 4);  // the other's 4 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (C > 1) cluster_sync();  // every block's barriers are set
  if (tid == 0) {  // W^T's COLS rows of every atom, once
    mbar_expect(wbar, G::W_BYTES);
    for (int a = 0; a < G::ATOMS; ++a)
      bulk_copy(w_u32 + a * G::PLANE,
                w + (size_t)(rank * G::ATOMS + a) * G::PLANE, G::PLANE,
                wbar);
  }

  // (row, column) of acc[e] in the item's tile, e = j 4 + i (j the n8
  // block of the block's columns)
  auto row_of = [&](int e) { return wl * 16 + g + 8 * ((e & 3) >> 1); };
  auto col_of = [&](int e) {
    return (int)rank * G::COLS + 8 * (e >> 2) + 2 * t4 + (e & 1);
  };
  int acc[G::NACC];
#pragma unroll
  for (int e = 0; e < G::NACC; ++e) acc[e] = 0;
  auto final_value = [&](int e) -> int {
    if constexpr (MODE == INT8)
      return (int)(int8_t)(uint8_t)((uint32_t)(acc[e] >> 7) & 0xffu);
    else
      return acc[e];
  };
  // y's every byte = v (y0; int8i's constant of each product)
  auto fill = [&](uint32_t v) {
    const uint32_t v4 = v * 0x01010101u;
    uint4* y4 = reinterpret_cast<uint4*>(ys);
    for (int i = wt; i < G::Y_BYTES / 16; i += 128)
      y4[i] = make_uint4(v4, v4, v4, v4);
  };
  const int clusters = gridDim.x / C, slots = clusters * WGS;
  const int items = steps * TILES;
  const uint32_t own = rank * G::OWN * Y_ATOM;  // this block's half of y
  bool w_ready = false;
  uint32_t n_full = 0, n_empty = 0;  // phases of full / empty completed

  for (int item = (int)(blockIdx.x / C) * WGS + h; item < items;
       item += slots) {
    const int step = item / TILES, tile = item % TILES;
    int seed;
    {  // the step's 1,024 bytes, 8 a thread
      const uint2 q =
          reinterpret_cast<const uint2*>(x + (size_t)step * XBLOCK)[wt];
      int s = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        s += (int)((q.x >> (8 * b)) & 0xffu) + (int)((q.y >> (8 * b)) & 0xffu);
      s = __reduce_add_sync(0xffffffffu, s);
      if (lane == 0) redi[h][wl] = s;
      wg_sync(h);  // (the last product's reads of y are done too)
      seed = redi[h][0] + redi[h][1] + redi[h][2] + redi[h][3];
    }
    const int base = seed & 63;
    fill((uint32_t)base);
    if constexpr (SWAP) {  // all of y0 is here: the first product's phase
      if (wt == 0) mbar_arrive(full);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(h);  // y is written before the wgmmas read it

    for (int d = 0; d < DEPTH; ++d) {
      if (!w_ready) {
        mbar_wait(wbar, 0);
        w_ready = true;
      }
      // ---- the product: y (A) x W^T's planes (B), all from shared
      // memory, atom a = (i + rank OWN) % ATOMS i-th: the block's own half
      // of y first
      const int keep = MODE == INT8I && d > 0;  // int8i sums on
      auto product = [&](int i0, int i1) {
#pragma unroll
        for (int i = i0; i < i1; ++i) {
          const int a = (i + (int)rank * G::OWN) % G::ATOMS;
#pragma unroll
          for (int kk = 0; kk < KA / 32; ++kk) {
            const uint64_t da = wgmma_desc(y_u32 + a * Y_ATOM + 32 * kk);
#pragma unroll
            for (int p = 0; p < G::PARTS; ++p)
              wgmma_s8<G::WN>(acc + p * (G::WN / 2), da,
                              wgmma_desc(w_u32 + a * G::PLANE +
                                         p * G::WN * KA + 32 * kk),
                              keep || i > 0 || kk > 0);
          }
        }
        wgmma_commit();
      };
      fence_sums(acc);
      wgmma_fence();
      if constexpr (SWAP) {  // the other half once it has landed
        product(0, G::OWN);
        mbar_wait(full, n_full++ & 1);
        product(G::OWN, G::ATOMS);
      } else {
        product(0, G::ATOMS);
      }
      wgmma_wait<0>();
      fence_sums(acc);
      if constexpr (SWAP) {
        // the phase of the other block's next copy; this warp's reads of y
        // are done: the other block may write its half; once its warps are
        // done too (and so this block's last copy has landed), this block
        // may write its own half and send it
        if (wt == 0 && d + 1 < DEPTH) mbar_expect(full, G::OWN * Y_ATOM);
        __syncwarp();
        if (lane == 0) mbar_arrive_at(empty, peer);
        mbar_wait(empty, n_empty++ & 1);
      }
      if (d + 1 == DEPTH) break;
      wg_sync(h);  // every warp's reads of y are done
      if constexpr (MODE == INT8) {  // y <- s8(acc >> 7), wrapping
#pragma unroll
        for (int e = 0; e < G::NACC; e += 2) {
          const int r = row_of(e), c = col_of(e);
          const uint32_t lo = (uint32_t)(acc[e] >> 7) & 0xffu;
          const uint32_t hi = (uint32_t)(acc[e + 1] >> 7) & 0xffu;
          *reinterpret_cast<uint16_t*>(
              ys + (c / KA) * Y_ATOM + r * KA +
              ((((c % KA) >> 4) ^ (r & 7)) << 4) + (c & 15)) =
              (uint16_t)(lo | (hi << 8));
        }
      } else {
        fill((uint32_t)(base + d + 1));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(h);  // y is written before the wgmmas (and the copy) read it
      if constexpr (SWAP) {
        if (wt == 0)
          bulk_copy_s2s(map_rank(y_u32 + own, peer), y_u32 + own,
                        G::OWN * Y_ATOM, map_rank(full, peer));
      }
    }

    if (tile == 0 && rank == 0 && wl == 0) {
      // the output: sum(y[0, 0:128]) over the (8, 128) block, exactly
      long long v = 0;
#pragma unroll
      for (int e = 0; e < 64; ++e)
        if ((e & 3) < 2 && g == 0) v += final_value(e);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const float s = (float)v;
      float4* o4 = reinterpret_cast<float4*>(out + (size_t)step * XBLOCK);
      for (int i = lane; i < XBLOCK / 4; i += 32)
        o4[i] = make_float4(s, s, s, s);
    }
    if constexpr (!CHECK) {
      // every final value stays live: the warpgroups of item sink_at (a
      // runtime index, -1 for none) add their sum to sink
      if (item == sink_at) {
        float v = 0.f;
#pragma unroll
        for (int e = 0; e < G::NACC; ++e) v += (float)final_value(e);
        atomicAdd(sink, v);
      }
    } else {
      // the moments of the item's final values, int64 modulo 2^64: any
      // order of the adds gives the same bits
      Mom m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
      for (int e = 0; e < G::NACC; ++e) {
        const int idx = (tile * TM + row_of(e)) * K + col_of(e);
        const Mom u = (Mom)(long long)final_value(e);
        m0 += u;
        m1 += u * u;
        m2 += (Mom)(idx % POS_PERIOD) * u;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m0 += __shfl_xor_sync(0xffffffffu, m0, o);
        m1 += __shfl_xor_sync(0xffffffffu, m1, o);
        m2 += __shfl_xor_sync(0xffffffffu, m2, o);
      }
      if (lane == 0) {
        Mom* mo = moments + ((size_t)step * TILES + tile) * 3;
        atomicAdd(mo, m0);
        atomicAdd(mo + 1, m1);
        atomicAdd(mo + 2, m2);
      }
    }
  }
  if (!w_ready) mbar_wait(wbar, 0);  // no block leaves with W in flight
  // ... nor while the other block may still copy into it or arrive on it
  if constexpr (C > 1) cluster_sync();
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, float*,
                        unsigned long long*, float*, int, int);

template <int K>
Kernel entry_k(int mode, bool check) {
  if (mode == INT8)
    return check ? chain_kernel<INT8, K, true> : chain_kernel<INT8, K, false>;
  return check ? chain_kernel<INT8I, K, true> : chain_kernel<INT8I, K, false>;
}
Kernel entry(int K, int mode, bool check) {
  return K == 384 ? entry_k<384>(mode, check) : entry_k<512>(mode, check);
}

struct Shape {
  int cluster, smem, w_bytes;
};
template <int K>
constexpr Shape shape_of() {
  return {Geo<K>::C, Geo<K>::SMEM, Geo<K>::W_BYTES};
}
Shape shape(int K) { return K == 384 ? shape_of<384>() : shape_of<512>(); }

cudaLaunchConfig_t config(int K, int clusters, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  const Shape sh = shape(K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.cluster * clusters, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters the card runs at once at K, asked once a device (the
// attributes of every instantiation set with it)
constexpr int kMaxDevices = 64;
std::atomic<int> g_active[kMaxDevices][2];  // [dev][K]

cudaError_t active_clusters(int K, int* active) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_active[dev][K == 512];
  if (!slot.load()) {
    for (int mode : {INT8, INT8I})
      for (bool check : {false, true}) {
        e = cudaFuncSetAttribute(entry(K, mode, check),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 shape(K).smem);
        if (e != cudaSuccess) return e;
      }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(K, 1, nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, entry(K, INT8, false), &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    slot.store(n);
  }
  *active = slot.load();
  return cudaSuccess;
}

int launch(const void* x, const void* w, void* out, void* moments, int steps,
           int K, int mode, void* sink, int sink_at, cudaStream_t s) {
  int active = 0;
  cudaError_t e = active_clusters(K, &active);
  if (e != cudaSuccess) return (int)e;
  const int items = steps * TILES, need = (items + WGS - 1) / WGS;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(K, active < need ? active : need, s, attr);
  e = cudaLaunchKernelEx(&cfg, entry(K, mode, moments != nullptr),
                         static_cast<const uint8_t*>(x),
                         static_cast<const uint8_t*>(w),
                         static_cast<float*>(out),
                         static_cast<unsigned long long*>(moments),
                         static_cast<float*>(sink), sink_at, steps);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace chain8

// ---------------------------------------------------------------- f32
// The f32 chain on clusters of C = 2 blocks a tile (mode 0; see the notes at
// the top).
namespace chain32 {

constexpr int BK = 32, ROW = 4 * BK;  // k a chunk; its bytes an n-row
constexpr int ALIGN = 1024;           // the swizzle's period: planes on it
constexpr int MAX_UNITS = 8;
constexpr int C = 2;  // blocks a cluster: a tile's two halves of the columns
// a block's dynamic shared memory, beside its static 1 KB or less
constexpr int SMEM_BUDGET = 232448 - 1024;
// How much of the kernel runs (dot_chain_f32_stop, to time its parts): all
// of it; hi*hi alone (one TF32 pass, another function); no exchange (each
// block's y keeps its old other half after a product); no feed (W's
// planes come into the ring once, then the MMAs re-read the ring's stale
// planes)
enum Stop { kAll = 0, kOnePass = 1, kNoExchange = 2, kNoFeed = 3 };

// K's geometry: block `rank` of the cluster computes the columns [rank
// COLS, rank COLS + COLS) of every product (its half of y), its warpgroup
// h the WIDTH from rank COLS + h WIDTH. A plane is W^T's COLS rows of the
// block for 32 k ([COLS][128 bytes], the 128-byte swizzle), hi or lo; a
// unit of the ring holds both planes of a chunk where two such units fit
// beside y (TM x K f32; K=384), else one plane (K=512), as many units as
// fit, two 8-byte barriers each, ALIGN bytes to start the ring on 1024.
// At n128 a warpgroup's sums, their total and two sets of split fragments
// would not fit in 255 registers: one set (PING false) is reloaded after a
// chunk's wgmmas.
template <int K>
struct Geo {
  static constexpr int COLS = K / C, WIDTH = COLS / 2;
  static constexpr int PLANE = COLS * ROW;
  static constexpr int CHUNKS = K / BK, HALF = CHUNKS / 2;  // a product's
  static constexpr int Y_BYTES = TM * K * 4;
  static constexpr int ROOM = SMEM_BUDGET - ALIGN - Y_BYTES - 16 * MAX_UNITS;
  static constexpr int UNIT_PLANES = ROOM / (2 * PLANE) >= 2 ? 2 : 1;
  static constexpr int UNIT = UNIT_PLANES * PLANE, UPC = 2 / UNIT_PLANES;
  static constexpr int UNITS =
      ROOM / UNIT < MAX_UNITS ? ROOM / UNIT : MAX_UNITS;
  static constexpr int SMEM = ALIGN + UNITS * UNIT + Y_BYTES + 16 * UNITS;
  static constexpr int NACC = WIDTH / 2;  // a thread's sums (64 x WIDTH)
  static constexpr bool PING = WIDTH <= 96;
  static_assert(K % (2 * C) == 0 && WIDTH % 8 == 0 && HALF % 2 == 0 &&
                    UNITS * UNIT_PLANES >= 3 && PLANE % ALIGN == 0 &&
                    SMEM <= SMEM_BUDGET,
                "whole n8 blocks, a ring, planes on the swizzle's period");
};

// grid (C x clusters), clusters of C along x: cluster i walks the items
// (step, tile) = i, i + clusters, ... (item = step TILES + tile), each
// block of it computing its half of the columns of every product of the
// tile's 64 rows. A block takes a product's chunks from its own half of y
// on (chunk (i + rank HALF) % CHUNKS i-th), so that it can run the first
// half of them on the half that it wrote itself: after a product it writes
// its new half into its own y and arrives on the cluster barrier; halfway
// through the next product it waits there (the other block is done
// reading the old y), copies its half into the other block's y, and meets
// it again before the chunks of the other half. Thread 0 streams the
// units, in that chunk order, DEPTH products an item, into the ring (a
// unit's slot refilled once the 8 warps have arrived on its empty
// barrier); every warp waits on a chunk's units, runs its 12 wgmmas (lo*hi,
// hi*lo, hi*hi for each k8), adds their sum into the product's total and
// frees the units.
template <int K, bool CHECK, int STOP>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const uint8_t* __restrict__ x, const float* __restrict__ wt,
             float* __restrict__ out, double* __restrict__ moments,
             float* __restrict__ sink, int sink_at, int steps) {
  using G = Geo<K>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                              (ALIGN - 1));
  float* ys = reinterpret_cast<float*>(ring + G::UNITS * G::UNIT);
  const uint32_t full0 = smem_u32(ring + G::UNITS * G::UNIT + G::Y_BYTES);
  const uint32_t empty0 = full0 + 8 * G::UNITS;
  __shared__ float row0[ROW0];
  __shared__ int redi[NWARPS + 1];
  __shared__ double redm[NWARPS + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = warp / 4, wl = warp % 4, g = lane >> 2, t4 = lane & 3;
  const uint32_t rank = cta_rank();
  const int clusters = gridDim.x / C, items = steps * TILES;
  const int first = blockIdx.x / C;
  const int count =  // the units this block reads
      (items - first + clusters - 1) / clusters * DEPTH * G::CHUNKS * G::UPC;
  // the i-th chunk of a product, from this block's own half of y on
  auto chunk_at = [&](int i) { return (i + (int)rank * G::HALF) % G::CHUNKS; };
  if (tid == 0) {
    for (int s = 0; s < G::UNITS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every block of the cluster runs before any writes y

  int issued = 0;
  auto issue = [&] {  // thread 0: the stream's next unit, once its slot is
    const int u = issued++;  // free
    const int s = u % G::UNITS, round = u / G::UNITS;
    if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
    const uint32_t bar = full0 + 8 * s, dst = smem_u32(ring + s * G::UNIT);
    mbar_expect(bar, G::UNIT);
    const int c = chunk_at(u / G::UPC % G::CHUNKS);
    for (int p = 0; p < G::UNIT_PLANES; ++p) {
      const int plane = G::UPC == 2 ? u % 2 : p;
      bulk_copy(dst + p * G::PLANE,
                wt + ((size_t)(c * 2 + plane) * K + rank * G::COLS) * BK,
                G::PLANE, bar);
    }
  };
  if (tid == 0)
    while (issued < count && issued < G::UNITS) issue();

  // (row, column) of acc[e] in the tile, e = j 4 + i (j the warpgroup's n8
  // block); y[r][c] lies at ys[r K + (c ^ 4 (r % 8))]
  auto row_of = [&](int e) { return wl * 16 + g + 8 * ((e & 3) >> 1); };
  auto col_of = [&](int e) {
    return (int)rank * G::COLS + h * G::WIDTH + e / 4 * 8 + 2 * t4 + (e & 1);
  };
  const int sw = g << 2;  // the swizzle of this thread's rows (r % 8 = g)
  const float* yf = ys + (wl * 16 + g) * K;
  // the fragments of y's chunk c for this warp's 16 rows, split
  auto load = [&](uint32_t (&ah)[4][4], uint32_t (&al)[4][4], int c) {
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {
      const int k = c * BK + k8 * 8 + t4;
      const float v[4] = {yf[k ^ sw], yf[8 * K + (k ^ sw)],
                          yf[(k + 4) ^ sw], yf[8 * K + ((k + 4) ^ sw)]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], ah[k8][i], al[k8][i]);
    }
  };
  float acc[G::NACC], total[G::NACC];
#pragma unroll
  for (int i = 0; i < G::NACC; ++i) acc[i] = 0.f;
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  auto fence_all = [&] {
    fence_acc(acc);
    fence_regs(ah0);
    fence_regs(al0);
    if constexpr (G::PING) {
      fence_regs(ah1);
      fence_regs(al1);
    }
  };
  const uint32_t ring_u32 = smem_u32(ring) + h * G::WIDTH * ROW;
  int t = 0;  // the stream's chunk that this block reads next
  auto wait_unit = [&](int u) {
    if (STOP != kNoFeed || u < G::UNITS)
      mbar_wait(full0 + 8 * (u % G::UNITS), (u / G::UNITS) & 1);
  };
  auto release = [&](int u) {  // this warp is done with unit u's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (u % G::UNITS));
  };
  // the i-th chunk of a product on the set loaded for it; the next one's
  // set (`more`: one more in this half) loaded while its wgmmas run
  // (PING), or after them into the same set. A chunk's units are waited
  // for before its wgmmas: a barrier's wait between them would put ptxas's
  // own wgmma fence on a divergent path, which serializes the wgmmas.
  auto chunk = [&](int i, bool more, uint32_t (&ah)[4][4],
                   uint32_t (&al)[4][4], uint32_t (&nh)[4][4],
                   uint32_t (&nl)[4][4]) {
    const int u = G::UPC * t;
    const uint32_t bh = ring_u32 + u % G::UNITS * G::UNIT;
    const uint32_t bl = G::UPC == 2
                            ? ring_u32 + (u + 1) % G::UNITS * G::UNIT
                            : bh + G::PLANE;
    wait_unit(u);
    if constexpr (G::UPC == 2) wait_unit(u + 1);
    fence_acc(acc);
    wgmma_fence();
    wgmma_chunk<G::WIDTH, STOP == kOnePass ? 1 : 3>(acc, ah, al, bh, bl - bh,
                                                    true);
    wgmma_commit();
    if constexpr (G::PING) {
      if (more) load(nh, nl, chunk_at(i + 1));
    }
    wgmma_wait<0>();
    fence_all();
#pragma unroll
    for (int j = 0; j < G::NACC; ++j) total[j] += acc[j];
    release(u);
    if constexpr (G::UPC == 2) release(u + 1);
    if (STOP != kNoFeed && tid == 0)
      while (issued < count && issued < u + G::UPC + G::UNITS) issue();
    if constexpr (!G::PING) {
      if (more) load(nh, nl, chunk_at(i + 1));
    }
    ++t;
  };
  // this block's half of y, rows r < TM: K / C floats at r K + rank COLS
  // (the swizzle keeps a column within its 32), 16 bytes a thread a step
  constexpr int ROW4 = G::COLS / 4;
  float4* mine = reinterpret_cast<float4*>(ys + rank * G::COLS);

  for (int item = first; item < items; item += clusters) {
    const int step = item / TILES, tile = item % TILES;
    const int seed = step_seed(x, step, redi);
    {  // y0: every element equal, so the layout does not matter here
      const float y0 = (float)seed * 1e-6f;
      for (int i = tid; i < TM * K / 4; i += THREADS)
        reinterpret_cast<float4*>(ys)[i] = make_float4(y0, y0, y0, y0);
    }
    __syncthreads();
    for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
      for (int i = 0; i < G::NACC; ++i) total[i] = 0.f;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        if (half == 1 && d > 0 && STOP != kNoExchange) {
          cluster_wait();  // the other block is done reading the old y
          const uint32_t there = map_rank(smem_u32(mine), rank ^ 1);
          for (int i = tid; i < TM * ROW4; i += THREADS) {
            const int o = i / ROW4 * (K / 4) + i % ROW4;
            st_cluster4(there + 16 * o, mine[o]);
          }
          cluster_arrive();
          cluster_wait();  // ... and has written its half into this y
        }
        const int i0 = half * G::HALF;
        load(ah0, al0, chunk_at(i0));
#pragma unroll 1
        for (int i = i0; i < i0 + G::HALF; i += 2) {
          const bool more = i + 2 < i0 + G::HALF;
          if constexpr (G::PING) {
            chunk(i, true, ah0, al0, ah1, al1);
            chunk(i + 1, more, ah1, al1, ah0, al0);
          } else {
            chunk(i, true, ah0, al0, ah0, al0);
            chunk(i + 1, more, ah0, al0, ah0, al0);
          }
        }
      }
      if (d + 1 == DEPTH) break;
      __syncthreads();  // every warp is done reading this y
#pragma unroll
      for (int e = 0; e < G::NACC; e += 2) {  // the new half, into this y
        const int r = row_of(e), c = col_of(e);
        *reinterpret_cast<float2*>(ys + r * K + (c ^ sw)) =
            make_float2(total[e], total[e + 1]);
      }
      __syncthreads();  // ... before its first chunks read it
      if (STOP != kNoExchange) cluster_arrive();
    }

    if (tile == 0) {  // the output: sum(y[0, 0:128]) over the (8, 128) block
      const uint32_t r0 = map_rank(smem_u32(row0), 0);
#pragma unroll
      for (int e = 0; e < G::NACC; ++e)
        if (row_of(e) == 0 && col_of(e) < ROW0)
          st_cluster(r0 + 4 * col_of(e), total[e]);
      cluster_sync();  // block 0's row0 is whole
      if (rank == 0 && warp == 0) {
        float v = 0.f;
        for (int q = 0; q < 4; ++q) v += row0[4 * lane + q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        float4* o4 = reinterpret_cast<float4*>(out + (size_t)step * XBLOCK);
        for (int i = lane; i < XBLOCK / 4; i += 32)
          o4[i] = make_float4(v, v, v, v);
      }
    }
    if constexpr (!CHECK) {
      // every final value stays live (see the int modes' kernel)
      if (item == sink_at) {
        float v = 0.f;
#pragma unroll
        for (int e = 0; e < G::NACC; ++e) v += total[e];
        atomicAdd(sink, v);
      }
    } else {
      double m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
      for (int e = 0; e < G::NACC; ++e) {
        const int idx = (tile * TM + row_of(e)) * K + col_of(e);
        const double dv = (double)total[e];
        m0 += dv;
        m1 += dv * dv;
        m2 += (double)(idx % POS_PERIOD) * dv;
      }
      m0 = block_sum<double>(m0, redm);
      m1 = block_sum<double>(m1, redm);
      m2 = block_sum<double>(m2, redm);
      if (tid == 0) {
        double* mo = moments + ((size_t)item * C + rank) * 3;
        mo[0] = m0;
        mo[1] = m1;
        mo[2] = m2;
      }
    }
  }
  // no block leaves while another may still write into it
  cluster_sync();
}

using Kernel = void (*)(const uint8_t*, const float*, float*, double*, float*,
                        int, int);

template <int K>
Kernel entry_k(bool check, int stop) {
  if (check) return chain_kernel<K, true, kAll>;
  switch (stop) {
    case kOnePass: return chain_kernel<K, false, kOnePass>;
    case kNoExchange: return chain_kernel<K, false, kNoExchange>;
    case kNoFeed: return chain_kernel<K, false, kNoFeed>;
    default: return chain_kernel<K, false, kAll>;
  }
}
Kernel entry(int K, bool check, int stop) {
  return K == 384 ? entry_k<384>(check, stop) : entry_k<512>(check, stop);
}

struct Shape {
  int units, smem, unit;
};
template <int K>
constexpr Shape shape_of() {
  return {Geo<K>::UNITS, Geo<K>::SMEM, Geo<K>::UNIT};
}
Shape shape(int K) { return K == 384 ? shape_of<384>() : shape_of<512>(); }

cudaLaunchConfig_t config(int K, int clusters, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * clusters, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = shape(K).smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters the card runs at once at K, asked once a device (the
// attributes of every instantiation set with it)
constexpr int kMaxDevices = 64;
std::atomic<int> g_active[kMaxDevices][2];  // [dev][K]

cudaError_t active_clusters(int K, int* active) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_active[dev][K == 512];
  if (!slot.load()) {
    for (bool check : {false, true})
      for (int stop : {kAll, kOnePass, kNoExchange, kNoFeed}) {
        e = cudaFuncSetAttribute(entry(K, check, stop),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 shape(K).smem);
        if (e != cudaSuccess) return e;
      }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(K, 1, nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, entry(K, false, kAll), &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    slot.store(n);
  }
  *active = slot.load();
  return cudaSuccess;
}

int launch(const void* x, const void* w, void* out, void* moments, int steps,
           int K, int stop, void* sink, int sink_at, cudaStream_t s) {
  int active = 0;
  cudaError_t e = active_clusters(K, &active);
  if (e != cudaSuccess) return (int)e;
  const int items = steps * TILES;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(K, active < items ? active : items, s, attr);
  e = cudaLaunchKernelEx(&cfg, entry(K, moments != nullptr, stop),
                         static_cast<const uint8_t*>(x),
                         static_cast<const float*>(w),
                         static_cast<float*>(out),
                         static_cast<double*>(moments),
                         static_cast<float*>(sink), sink_at, steps);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace chain32

// ---------------------------------------------------------------- bf16
// The bf16 chain on a cluster ring (mode 1; see the notes at the top).
namespace chain16 {

constexpr int CONSUMERS = 256, CWARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;  // 8 MMA warps and 1 copy warp
constexpr int KA = 64, ROW = 2 * KA;     // k a chunk; its bytes an n-row
constexpr int Y_ATOM = TM * ROW;         // y's bytes of 64 k-columns
constexpr int MAX_STAGES = 8;
constexpr int ALIGN = 1024;  // the swizzle's period: planes start on it
// a block's dynamic shared memory, beside its static 1 KB or less
constexpr int SMEM_BUDGET = 232448 - 1024;
constexpr int CLUSTERS[] = {1, 2, 3, 6};  // divisors of TILES

// K's geometry: a chunk is 64 k-columns of W^T (one 128-byte row an n)
// for one half of the n (columns of y W), HALF rows; a product's chunks
// go atom by atom, half 0 then half 1; y is TM rows x K in bf16, both in
// the swizzled layout (16-byte unit u of a 128-byte row r stored at
// u ^ (r % 8): wgmma's 128-byte swizzle); the ring takes what y leaves,
// at most MAX_STAGES; then the full and empty mbarrier of each stage;
// ALIGN bytes to start y on 1024
template <int K>
struct Geo {
  static constexpr int HALF = K / 2, CHUNK = HALF * ROW;
  static constexpr int ATOMS = K / KA, CHUNKS = 2 * ATOMS;
  static constexpr int Y_BYTES = TM * K * 2;
  static constexpr int FIT =
      (SMEM_BUDGET - ALIGN - Y_BYTES - 16 * MAX_STAGES) / CHUNK;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = ALIGN + Y_BYTES + STAGES * CHUNK + 16 * STAGES;
  static constexpr int NACC = K / 4;  // a thread's sums (64 x K/2 a group)
  static_assert(K % 128 == 0 && HALF % 8 == 0 && STAGES >= 2 &&
                    SMEM <= SMEM_BUDGET && Y_BYTES % ALIGN == 0 &&
                    CHUNK % ALIGN == 0,
                "whole atoms, swizzle rows, a ring, aligned planes");
};

// the 8 MMA warps alone (the copy warp never waits on them)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// byte offset of the 16-byte unit u of row r in a swizzled 128-byte-row
// plane
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (uint32_t)(r * ROW + ((u ^ (r & 7)) << 4));
}
// this warp's share of d (64 x 256 f32) = A B (scale_d 0) or d + A B:
// wgmma m64n256k16 bf16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,"
      "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// this warp's share of d (64 x 192 f32) = A B (scale_d 0) or d + A B:
// wgmma m64n192k16 bf16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_half(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (K == 512)
    wgmma_n256(d, da, db, scale_d);
  else
    wgmma_n192(d, da, db, scale_d);
}

template <typename T>
__device__ T consumer_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  consumer_sync();
  if (threadIdx.x == 0) {
    T s = 0;
    for (int i = 0; i < CWARPS; ++i) s += red[i];
    red[CWARPS] = s;
  }
  consumer_sync();
  const T s = red[CWARPS];
  consumer_sync();
  return s;
}

// grid (TILES, steps), clusters of C along the tiles: block (tile, step)
// runs the step's rows [tile TM, tile TM + TM) through the 14 products.
// Warp 8 (one thread) streams W's chunks, DEPTH times over, into the ring:
// in a cluster each block copies its share of a chunk's rows into every
// block's stage (multicast) once every block's MMA warps have freed that
// stage (its empty barrier counts 4 warps of each of the C blocks), and
// the stage's full barrier waits for all of the chunk's bytes. Warps 4 h
// to 4 h + 3, a warpgroup, take the columns of half h, the chunks (a, h):
// one wgmma m64n(K/2)k16 a k16 step reading y and the chunk from shared
// memory, a chunk's stage freed once the next chunk's wgmmas are in
// flight. f32 sums in k order; after a product the MMA warps round
// their sums to bf16 into y, between two barriers of their own.
template <int K, int C, bool CHECK>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
             float* __restrict__ out, double* __restrict__ moments,
             __nv_bfloat16* __restrict__ trace, float* __restrict__ sink,
             int sink_at) {
  using G = Geo<K>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* ys = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) &
                            (ALIGN - 1));
  uint8_t* ring = ys + G::Y_BYTES;
  const uint32_t full0 = smem_u32(ring + G::STAGES * G::CHUNK);
  const uint32_t empty0 = full0 + 8 * G::STAGES;
  __shared__ float row0[ROW0];
  __shared__ int redi[CWARPS + 1];
  __shared__ double redm[CWARPS + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, step = blockIdx.y;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (C > 1) cluster_sync();  // every block's barriers are set

  if (warp == CWARPS) {  // ---- the copy warp
    if (lane == 0) {
      const uint32_t rank = C > 1 ? cta_rank() : 0;
      const int lo = rank * G::HALF / C, hi = (rank + 1) * G::HALF / C;
      const uint32_t bytes = (hi - lo) * ROW;
      for (int t = 0; t < DEPTH * G::CHUNKS; ++t) {
        const int s = t % G::STAGES, round = t / G::STAGES;
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        mbar_expect(full0 + 8 * s, G::CHUNK);
        const int c = t % G::CHUNKS;  // atom c / 2, half c % 2
        const uint8_t* src =
            w + ((size_t)(c / 2) * K + (c % 2) * G::HALF + lo) * ROW;
        const uint32_t dst = smem_u32(ring + s * G::CHUNK + lo * ROW);
        if constexpr (C == 1)
          bulk_copy(dst, src, bytes, full0 + 8 * s);
        else
          bulk_copy_multicast(dst, src, bytes, full0 + 8 * s,
                              (uint16_t)((1u << C) - 1));
      }
    }
    __syncwarp();
  } else {  // ---- the MMA warps
    const uint32_t word =
        reinterpret_cast<const uint32_t*>(x + (size_t)step * XBLOCK)[tid];
    const int seed = consumer_sum<int>(
        (int)((word & 0xffu) + ((word >> 8) & 0xffu) + ((word >> 16) & 0xffu) +
              (word >> 24)), redi);
    {  // y0: every element equal, so the layout does not matter here
      const __nv_bfloat162 y0 =
          __bfloat162bfloat162(__float2bfloat16_rn((float)seed * 1e-6f));
      for (int i = tid; i < G::Y_BYTES / 4; i += CONSUMERS)
        reinterpret_cast<__nv_bfloat162*>(ys)[i] = y0;
    }
    // y's generic writes, before wgmma reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();

    const int g = lane >> 2, t4 = lane & 3;
    const int half = warp / 4, wl = warp % 4;
    const uint32_t y_u32 = smem_u32(ys), ring_u32 = smem_u32(ring);
    float acc[G::NACC];
    // (row, column) in the tile of acc[e], e = j 4 + i (j the
    // warpgroup's n8 block)
    auto row_of = [&](int e) { return wl * 16 + g + 8 * ((e & 3) >> 1); };
    auto col_of = [&](int e) {
      return half * G::HALF + e / 4 * 8 + 2 * t4 + (e & 1);
    };
    auto release = [&](int s) {  // this warp is done with stage s
      __syncwarp();
      if (lane < C) mbar_arrive_at(empty0 + 8 * s, lane);
    };
    for (int d = 0; d < DEPTH; ++d) {
      int held = -1;  // the stage whose wgmmas may still run
#pragma unroll 1
      for (int a = 0; a < G::ATOMS; ++a) {
        const int t = d * G::CHUNKS + 2 * a + half;
        const int s = t % G::STAGES;
        mbar_wait(full0 + 8 * s, (t / G::STAGES) & 1);
        const uint32_t stage = ring_u32 + s * G::CHUNK;
        const uint32_t yatom = y_u32 + a * Y_ATOM;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KA / 16; ++kk)
          wgmma_half<K>(acc, wgmma_desc(yatom + 32 * kk),
                        wgmma_desc(stage + 32 * kk), a > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the chunk before this one is read
        if (held >= 0) release(held);
        held = s;
      }
      wgmma_wait<0>();
      release(held);
      if constexpr (CHECK) {  // the traced row after product d
        const int trow = TRACE_STRIDE * tile % TM;
        __nv_bfloat16* tr =
            trace + (((size_t)step * TILES + tile) * DEPTH + d) * K;
#pragma unroll
        for (int e = 0; e < G::NACC; ++e)
          if (row_of(e) == trow) tr[col_of(e)] = __float2bfloat16_rn(acc[e]);
      }
      if (d + 1 < DEPTH) {  // y for the next product, rounded to bf16
        consumer_sync();    // every MMA warp is done reading y
#pragma unroll
        for (int e = 0; e < G::NACC; e += 2) {
          const int r = row_of(e), c = col_of(e);
          *reinterpret_cast<__nv_bfloat162*>(
              ys + (c / KA) * Y_ATOM + swz(r, (c % KA) / 8) + (c % 8) * 2) =
              __floats2bfloat162_rn(acc[e], acc[e + 1]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync();
      }
    }

    auto final_value = [&](int e) {
      return __bfloat162float(__float2bfloat16_rn(acc[e]));
    };
    if (tile == 0) {  // the output: sum(y[0, 0:128]) over the (8, 128) block
#pragma unroll
      for (int e = 0; e < G::NACC; ++e)
        if (row_of(e) == 0 && col_of(e) < ROW0)
          row0[col_of(e)] = final_value(e);
      consumer_sync();
      if (warp == 0) {
        float v = 0.f;
        for (int q = 0; q < 4; ++q) v += row0[4 * lane + q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        float4* o4 = reinterpret_cast<float4*>(out + (size_t)step * XBLOCK);
        for (int i = lane; i < XBLOCK / 4; i += 32)
          o4[i] = make_float4(v, v, v, v);
      }
    }
    if constexpr (!CHECK) {
      // every final value stays live (see the int modes' kernel)
      if (step * TILES + tile == sink_at) {
        float v = 0.f;
#pragma unroll
        for (int e = 0; e < G::NACC; ++e) v += final_value(e);
        atomicAdd(sink, v);
      }
    } else {
      double m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
      for (int e = 0; e < G::NACC; ++e) {
        const int idx = (tile * TM + row_of(e)) * K + col_of(e);
        const double dv = (double)final_value(e);
        m0 += dv;
        m1 += dv * dv;
        m2 += (double)(idx % POS_PERIOD) * dv;
      }
      m0 = consumer_sum<double>(m0, redm);
      m1 = consumer_sum<double>(m1, redm);
      m2 = consumer_sum<double>(m2, redm);
      if (tid == 0) {
        double* mo = moments + ((size_t)step * TILES + tile) * 3;
        mo[0] = m0;
        mo[1] = m1;
        mo[2] = m2;
      }
    }
  }
  // no block leaves while another may still copy into it or arrive on it
  if constexpr (C > 1) cluster_sync();
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, float*, double*,
                        __nv_bfloat16*, float*, int);

template <int K, bool CHECK>
Kernel entry_c(int C) {
  switch (C) {
    case 1: return chain_kernel<K, 1, CHECK>;
    case 2: return chain_kernel<K, 2, CHECK>;
    case 3: return chain_kernel<K, 3, CHECK>;
    default: return chain_kernel<K, 6, CHECK>;
  }
}

Kernel entry(int K, int C, bool check) {
  if (K == 384) return check ? entry_c<384, true>(C) : entry_c<384, false>(C);
  return check ? entry_c<512, true>(C) : entry_c<512, false>(C);
}

int smem_of(int K) {
  return K == 384 ? Geo<384>::SMEM : Geo<512>::SMEM;
}

cudaLaunchConfig_t config(int K, int C, int steps, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(TILES, steps, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_of(K);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of C blocks the card runs at once, for the (K, C) timed
// kernel, asked once a device (the attributes of both instantiations set
// with it)
constexpr int kMaxDevices = 64;
std::atomic<int> g_active[kMaxDevices][2][7];  // [dev][K][C]

cudaError_t active_clusters(int K, int C, int* active) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_active[dev][K == 512][C];
  if (!slot.load()) {
    for (bool check : {false, true}) {
      e = cudaFuncSetAttribute(entry(K, C, check),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_of(K));
      if (e != cudaSuccess) return e;
    }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(K, C, 1, nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, entry(K, C, false), &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;
    slot.store(n);
  }
  *active = slot.load();
  return cudaSuccess;
}

// the cluster size of variant 0: of the sizes whose clusters cover at
// least 15/16 of the SMs at once, the largest (the larger the cluster, the
// fewer L2 reads of W)
cudaError_t choose_cluster(int K, int* C) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *C = 1;
  for (int c : CLUSTERS) {
    int active = 0;
    if (e == cudaSuccess) e = active_clusters(K, c, &active);
    if (e == cudaSuccess && 16 * active * c >= 15 * sms) *C = c;
  }
  return e;
}

// variant: the cluster size (0: choose_cluster's)
cudaError_t resolve(int K, int variant, int* C) {
  *C = variant;
  return *C ? cudaSuccess : choose_cluster(K, C);
}

bool variant_ok(int variant) {
  return variant == 0 || variant == 1 || variant == 2 || variant == 3 ||
         variant == 6;
}

int launch(const void* x, const void* w, void* out, void* moments,
           void* trace, int steps, int K, int variant, void* sink,
           int sink_at, cudaStream_t s) {
  int C = 0, active = 0;
  cudaError_t e = resolve(K, variant, &C);
  if (e == cudaSuccess) e = active_clusters(K, C, &active);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(K, C, steps, s, attr);
  e = cudaLaunchKernelEx(
      &cfg, entry(K, C, moments != nullptr),
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<float*>(out), static_cast<double*>(moments),
      static_cast<__nv_bfloat16*>(trace), static_cast<float*>(sink), sink_at);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace chain16
}  // namespace

// x: (steps * 8, 128) uint8; w: for mode 0, W^T split hi / lo, (K / 32)
// chunks of (2, K, 32) f32 in the 128-byte swizzle (ops/cuda_dot_chain.
// pack_weights: chunk c, plane, row n, 16-byte unit u of W^T[n, 32 c + 4 u
// ...] at unit u ^ (n % 8)); for modes 2, 3 W^T in s8 in chain8's layout
// (block rank r of the cluster's C, atom a, row n of its K / C, 16-byte
// unit u of W^T[r K / C + n, 128 a + 16 u ...] at unit u ^ (n % 8)); for
// mode 1 W^T in bf16 in chain16's chunk layout (atom a, row n, 16-byte
// unit u of W^T[n, 64 a + 8 u ...] at unit u ^ (n % 8)); 16-byte aligned;
// out: (steps, 8, 128) f32; moments: nullptr, or the check instantiation's
// doubles (modes 0, 1) or int64 (modes 2, 3, zeroed by the caller: the
// kernel adds into them): (steps, 6, 3), in mode 0 (steps, 6, 2, 3), one
// triple a block of the cluster; trace: the check
// instantiation's (steps, 6, 14, K) bf16 in mode 1, else unused; sink: one
// f32 that the timed instantiation's block(s) of item sink_at (step * 6 +
// tile; -1: none) add the sum of their final values to. mode: 0 f32, 1
// bf16, 2 int8, 3 int8i; K: 384 or 512; variant: mode 1's blocks a cluster
// (1, 2, 3 or 6), 0 for dot_chain_plan's choice; 0 in the other modes.
// Every variant computes the same bits. Returns the cudaError_t of the
// launch.
extern "C" int dot_chain(const void* x, const void* w, void* out,
                         void* moments, void* trace, void* sink, int sink_at,
                         int steps, int K, int mode, int variant,
                         void* stream) {
  if (steps < 0 || (K != 384 && K != 512) || mode < F32 || mode > INT8I ||
      !(mode == BF16 ? chain16::variant_ok(variant) : variant == 0) ||
      (moments && mode == BF16 && !trace))
    return (int)cudaErrorInvalidValue;
  if (steps == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case F32:
      return chain32::launch(x, w, out, moments, steps, K, chain32::kAll,
                             sink, sink_at, s);
    case BF16:
      return chain16::launch(x, w, out, moments, trace, steps, K, variant,
                             sink, sink_at, s);
    default:
      return chain8::launch(x, w, out, moments, steps, K, mode, sink,
                            sink_at, s);
  }
}

// mode 0's timed instantiation with part of its work left out, to time
// where its time goes (another function: out holds other values); x, w,
// out, sink, steps, K as dot_chain takes them; stop: 1 one TF32 pass
// (hi*hi alone), 2 no exchange of y between products, 3 no feed of W
// after the ring's first fill. Returns the cudaError_t of the launch.
extern "C" int dot_chain_f32_stop(const void* x, const void* w, void* out,
                                  void* sink, int steps, int K, int stop,
                                  void* stream) {
  if (steps < 1 || (K != 384 && K != 512) || stop < chain32::kOnePass ||
      stop > chain32::kNoFeed)
    return (int)cudaErrorInvalidValue;
  return chain32::launch(x, w, out, nullptr, steps, K, stop, sink, -1,
                         static_cast<cudaStream_t>(stream));
}

// a mode's launch at K on the current card, variant as dot_chain takes
// it; out[0..7]: the cluster size, ring stages (mode 0: units, one plane of
// a chunk each; modes 2, 3: 1, W^T's planes resident), dynamic shared
// memory bytes a block, bytes a stage (modes 2, 3: the block's W^T
// planes), threads a block, the clusters of that size the card runs at
// once, the SMs they cover and the card's SMs. Returns the cudaError_t of
// the occupancy query.
extern "C" int dot_chain_plan(int K, int mode, int variant, int* out) {
  if ((K != 384 && K != 512) || mode < F32 || mode > INT8I ||
      !(mode == BF16 ? chain16::variant_ok(variant) : variant == 0))
    return (int)cudaErrorInvalidValue;
  int C = 0, active = 0, dev = 0, sms = 0;
  cudaError_t e = cudaSuccess;
  if (mode == F32) {
    C = chain32::C;
    e = chain32::active_clusters(K, &active);
  } else if (mode != BF16) {
    C = chain8::shape(K).cluster;
    e = chain8::active_clusters(K, &active);
  } else {
    e = chain16::resolve(K, variant, &C);
    if (e == cudaSuccess) e = chain16::active_clusters(K, C, &active);
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const bool k384 = K == 384;
  chain32::Shape f = {};
  if (mode == F32)
    f = chain32::shape(K);
  else if (mode != BF16)
    f = {1, chain8::shape(K).smem, chain8::shape(K).w_bytes};
  else
    f = {k384 ? chain16::Geo<384>::STAGES : chain16::Geo<512>::STAGES,
         chain16::smem_of(K),
         k384 ? chain16::Geo<384>::CHUNK : chain16::Geo<512>::CHUNK};
  const int fields[] = {C,      f.units,    f.smem, f.unit,
                        mode == BF16 ? chain16::THREADS : THREADS,
                        active, active * C, sms};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return 0;
}

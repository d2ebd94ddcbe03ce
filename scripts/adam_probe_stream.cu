// The persistent bulk-copy form of the Adam kernel, not taken, kept for
// scripts/torch_adam_probe.py: built appended to csrc/adam.cu (it uses its
// AdamArgs, Key, key_at, key_of and adam_one), entry point
// gs_adam_step_stream, the same arguments planned with chunks of
// kStreamChunk elements and a.blocks cut to kStreamPerSm blocks an SM.
//
// One flat element space over all keys in chunks that never straddle a key,
// walked by a persistent grid, chunk c by block c % grid. Each block keeps a
// ring of kStages chunks in shared memory, a chunk's p, g, m and v side by
// side. Thread 0 keeps the ring kStages - 1 chunks ahead with four 1-D bulk
// copies a chunk (cp.async.bulk.shared::cluster.global.mbarrier::
// complete_tx::bytes), one mbarrier a stage; every thread waits on the
// stage's barrier, computes its float4s from shared memory and writes p',
// m' and v' back over p, m and v there; after a barrier thread 0 stores the
// three whole (cp.async.bulk.global.shared::cta) and refills the stage the
// stores before have finished reading. The element index space (keys off
// the 16-byte grid, the last n % 4 elements of the others) follows over
// every thread of the grid.

namespace {

constexpr int kStreamChunk = 2048;            // elements a chunk: 8 KB an array
constexpr int kStages = 3;
constexpr int kStreamPerSm = 2;
constexpr int kStageFloats = 4 * kStreamChunk;  // p, g, m, v
constexpr int kStreamSmem = kStages * kStageFloats * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` of the barrier has completed; a wait
// of some seconds (copies that never land) traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* shared, const void* global, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(shared)), "l"(global), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_store(void* global, const void* shared, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(global), "r"(smem_addr(shared)), "r"(bytes) : "memory");
}

// generic-proxy writes to shared memory, seen by the bulk copies' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int chunk_len(const Key& s, long long start) {
  return static_cast<int>(min((long long)kStreamChunk, (s.n & ~3LL) - start));
}

// chunk c's p, g, m, v into stage `stage`, completing on `bar`
__device__ __forceinline__ void load_chunk(const AdamArgs& a, long long c, float* stage,
                                           uint64_t* bar) {
  const Key s = key_at(a, key_of(a.first_chunk, c));
  const long long start = (c - s.first_chunk) * kStreamChunk;
  const uint32_t bytes = 4u * static_cast<uint32_t>(chunk_len(s, start));
  mbar_expect(bar, 4u * bytes);
#pragma unroll
  for (int r = 0; r < 4; ++r) bulk_load(stage + r * kStreamChunk, s.in[r] + start, bytes, bar);
}

__global__ void __launch_bounds__(kThreads) adam_stream(const AdamArgs a) {
  extern __shared__ __align__(128) float ring[];   // [kStages][p, g, m, v][kStreamChunk]
  __shared__ __align__(8) uint64_t full[kStages];
  const int t = threadIdx.x;
  const long long total = a.first_chunk[kAdamMaxKeys];
  const long long mine =
      total > blockIdx.x ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (long long j = 0; j < kStages - 1 && j < mine; ++j)
      load_chunk(a, blockIdx.x + j * gridDim.x, ring + j * kStageFloats, &full[j]);
  }
  for (long long j = 0; j < mine; ++j) {
    const int stage = static_cast<int>(j % kStages);
    float* st = ring + stage * kStageFloats;
    const long long c = blockIdx.x + j * gridDim.x;
    const Key s = key_at(a, key_of(a.first_chunk, c));
    const long long start = (c - s.first_chunk) * kStreamChunk;
    const int len = chunk_len(s, start);
    mbar_wait(&full[stage], static_cast<uint32_t>((j / kStages) & 1));
    float4* q = reinterpret_cast<float4*>(st);
    for (int i = t; i < len / 4; i += kThreads) {
      const float4 p = q[i], g = q[i + kStreamChunk / 4], m = q[i + kStreamChunk / 2],
                   v = q[i + 3 * kStreamChunk / 4];
      float4 po, mo, vo;
      adam_four(a, s.neg_lr, p, g, m, v, po, mo, vo);
      q[i] = po;
      q[i + kStreamChunk / 2] = mo;
      q[i + 3 * kStreamChunk / 4] = vo;
    }
    fence_proxy_async();
    __syncthreads();
    if (t == 0) {
      const uint32_t bytes = 4u * static_cast<uint32_t>(len);
      bulk_store(s.out[0] + start, st, bytes);
      bulk_store(s.out[1] + start, st + 2 * kStreamChunk, bytes);
      bulk_store(s.out[2] + start, st + 3 * kStreamChunk, bytes);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      const long long next = j + kStages - 1;
      if (next < mine) {
        // the stores of chunk j - 1 have read the stage chunk `next` takes
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const int ns = static_cast<int>(next % kStages);
        load_chunk(a, blockIdx.x + next * gridDim.x, ring + ns * kStageFloats, &full[ns]);
      }
    }
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long x = (long long)blockIdx.x * kThreads + t; x < a.first_elem[kAdamMaxKeys];
       x += stride) {
    const Key s = key_at(a, key_of(a.first_elem, x));
    const long long i = s.elem_lo + (x - s.first_elem);
    adam_one(a, s.neg_lr, s.in[0][i], s.in[1][i], s.in[2][i], s.in[3][i], s.out[0][i],
             s.out[1][i], s.out[2][i]);
  }
  // shared memory must outlive the stores' reads of it
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" int gs_adam_stream_chunk() { return kStreamChunk; }

extern "C" int gs_adam_stream_per_sm() { return kStreamPerSm; }

extern "C" int gs_adam_step_stream(const void* args, void* stream) {
  const AdamArgs& a = *static_cast<const AdamArgs*>(args);
  if (a.keys < 1 || a.keys > kAdamMaxKeys || a.blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.blocks == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(adam_stream, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kStreamSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  adam_stream<<<a.blocks, kThreads, kStreamSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

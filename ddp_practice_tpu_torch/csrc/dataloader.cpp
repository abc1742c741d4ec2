// Native batch gather for ddp_practice_tpu_torch.data (data/loader.py
// backend "native", bound by data/native_loader.py through ctypes).
//
// The original script's input pipeline hot path is torch DataLoader
// worker processes doing fancy-indexed batch collation + pinned-memory
// copies (origin_main.py:91-107). Here the dataset stays one contiguous
// host array and each (already-sharded) batch is assembled with a
// multithreaded strided gather; the loop then pins the batch and copies it
// to the card without blocking.
//
// The C interface (ABI v3) is the reference package's native/dataloader.cpp
// unchanged, built apart into build/ddp_practice_tpu_torch/ with g++.
// Shuffling deliberately stays in Python/NumPy so the epoch order is
// bit-identical across the native and pure-Python backends.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Dataset {
  const uint8_t* images;  // (n, sample_elems) row-major, elem_bytes each
  const int32_t* labels;  // (n,)
  int64_t n;
  int64_t row_bytes;      // sample_elems * elem_bytes
};

// Byte-level rows: the same gather serves fp32 (MNIST/CIFAR in RAM) and
// uint8 (ImageNet-scale memmap) storage; for a memmapped corpus the
// memcpy's source reads fault pages in from disk, so this doubles as the
// streaming read path.
void gather_range(const Dataset& ds, const int64_t* indices, int64_t begin,
                  int64_t end, uint8_t* out_images, int32_t* out_labels,
                  std::atomic<bool>* oob) {
  for (int64_t i = begin; i < end; ++i) {
    int64_t src = indices[i];
    if (src < 0) src += ds.n;      // numpy-style negative wrapping
    if (src < 0 || src >= ds.n) {  // then numpy's IndexError contract
      oob->store(true, std::memory_order_relaxed);
      return;
    }
    std::memcpy(out_images + i * ds.row_bytes,
                ds.images + src * ds.row_bytes,
                static_cast<size_t>(ds.row_bytes));
    out_labels[i] = ds.labels[src];
  }
}

}  // namespace

extern "C" {

// Wraps caller-owned arrays; caller guarantees their lifetime.
// elem_bytes is the per-element width (4 for fp32, 1 for uint8).
void* dl_create(const void* images, const int32_t* labels, int64_t n,
                int64_t sample_elems, int32_t elem_bytes) {
  return new Dataset{static_cast<const uint8_t*>(images), labels, n,
                     sample_elems * elem_bytes};
}

void dl_destroy(void* handle) { delete static_cast<Dataset*>(handle); }

// Gather `count` samples by index into out buffers, using up to
// `num_threads` threads (<=0 means hardware concurrency). Returns 0 on
// success, -1 if any index is out of [0, n) — mirroring the numpy
// backend's IndexError instead of reading out-of-bounds memory.
int32_t dl_gather(void* handle, const int64_t* indices, int64_t count,
                  void* out_images_v, int32_t* out_labels,
                  int32_t num_threads) {
  uint8_t* out_images = static_cast<uint8_t*>(out_images_v);
  const Dataset& ds = *static_cast<Dataset*>(handle);
  std::atomic<bool> oob{false};
  int64_t nthreads = num_threads > 0
                         ? num_threads
                         : static_cast<int64_t>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  // Small batches: threading overhead dominates; stay single-threaded.
  const int64_t kMinPerThread = 64;
  if (count / kMinPerThread < nthreads) nthreads = count / kMinPerThread;
  if (nthreads <= 1) {
    gather_range(ds, indices, 0, count, out_images, out_labels, &oob);
    return oob.load() ? -1 : 0;
  }
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  const int64_t per = (count + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    const int64_t begin = t * per;
    const int64_t end = begin + per < count ? begin + per : count;
    if (begin >= end) break;
    workers.emplace_back(gather_range, std::cref(ds), indices, begin, end,
                         out_images, out_labels, &oob);
  }
  for (auto& w : workers) w.join();
  return oob.load() ? -1 : 0;
}

int32_t dl_version() { return 3; }

}  // extern "C"

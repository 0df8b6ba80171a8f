// chipstore: a native binary chip container + multithreaded batch loader
// (the PyTorch port's copy of cultionet_tpu/native/chipstore.cpp: the same
// file layout, so a store written by either package opens in the other, and
// the same C ABI but for the prefetch start below).
//
// Fixed-shape chips in one mmap'd file, zero-copy reads, and a C++
// background prefetch pipeline that assembles shuffled batches into a ring
// of slots while the card computes. Exposed as a plain C ABI consumed via
// ctypes (cultionet_tpu_torch/data/chipstore.py), built with g++ at first
// use.
//
// Two differences from the JAX package's copy. Slots are handed out in the
// order their batches were claimed (each claim takes a sequence number), so
// any number of worker threads yields the batches one thread would. With
// delivery in finish order, a batch claimed past an epoch's end could
// overtake the epoch's last batch and put a chip twice into that epoch.
// And cs_prefetch_start_block takes the place of cs_prefetch_start: its
// slots hold the rows [lo, hi) of each shuffled batch (the whole batch, or
// one data-parallel rank's block), so each rank reads and copies only its
// own chips from one shared store.
//
// File layout (little endian):
//   header:
//     char     magic[4] = "CTS1"
//     uint32   version             // 1 = float32 records, 2 = int16-packed
//     uint64   num_chips
//     uint32   t, h, w, c          // x dims per chip
//     uint32   has_labels          // 1 if y + bdist present
//     uint32   reserved
//   per chip (contiguous records), version 1:
//     float32  x[t*h*w*c]
//     int32    y[h*w]              // when has_labels
//     float32  bdist[h*w]          // when has_labels
//     float32  meta[8]             // left, bottom, right, top, lat, lon, 0, 0
//   per chip, version 2 (half the bytes of v1 — the int16 x 10000 packing the
//   reference stores chips in natively, data/constant.py:1; dequantized on
//   the accelerator):
//     int16    x[t*h*w*c]          // value x 10000
//     int16    y[h*w]              // when has_labels (class ids, -1 weak)
//     int16    bdist[h*w]          // when has_labels (value x 10000)
//     float32  meta[8]
//
// The loader is dtype-agnostic: records are raw byte spans; callers query
// per-field element sizes and supply matching buffers.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMetaFloats = 8;

struct Header {
  char magic[4];
  uint32_t version;
  uint64_t num_chips;
  uint32_t t, h, w, c;
  uint32_t has_labels;
  uint32_t reserved;
};

struct Store {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t file_size = 0;
  Header header{};
  size_t x_bytes = 0;
  size_t y_bytes = 0;
  size_t bdist_bytes = 0;
  size_t meta_bytes = kMetaFloats * sizeof(float);
  size_t record_bytes = 0;

  // Prefetch pipeline state: a ring of preallocated slots. Workers fill
  // free slots in place; the consumer maps them zero-copy and releases.
  struct Slot {
    std::vector<uint8_t> x;
    std::vector<uint8_t> y;
    std::vector<uint8_t> bdist;
    std::vector<uint8_t> meta;
    int64_t count = 0;
    uint64_t seq = 0;  // claim order of the batch it holds
  };
  std::vector<std::thread> workers;
  std::vector<Slot> slots;
  std::deque<int> ready;   // filled slot ids, in finish order
  std::deque<int> free_q;  // empty slot ids
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  std::vector<uint64_t> order;
  size_t cursor = 0;
  uint64_t next_claim = 0;    // sequence number of the next claimed batch
  uint64_t next_deliver = 0;  // sequence number cs_next_slot hands out next
  std::mutex cursor_mu;
  int64_t batch_size = 0;
  int64_t block_lo = 0;  // rows [block_lo, block_hi) of each batch go to
  int64_t block_hi = 0;  // the slot
  bool running = false;

  const uint8_t* record(uint64_t index) const {
    return data + sizeof(Header) + index * record_bytes;
  }
};

void copy_chip(const Store* s, uint64_t chip, uint8_t* x_out, uint8_t* y_out,
               uint8_t* bdist_out, uint8_t* meta_out) {
  const uint8_t* rec = s->record(chip);
  std::memcpy(x_out, rec, s->x_bytes);
  rec += s->x_bytes;
  if (s->header.has_labels) {
    if (y_out) std::memcpy(y_out, rec, s->y_bytes);
    rec += s->y_bytes;
    if (bdist_out) std::memcpy(bdist_out, rec, s->bdist_bytes);
    rec += s->bdist_bytes;
  }
  if (meta_out) std::memcpy(meta_out, rec, s->meta_bytes);
}

void worker_loop(Store* s, uint64_t seed) {
  std::mt19937_64 rng(seed);

  while (!s->stop.load()) {
    // Acquire a free slot.
    int slot_id = -1;
    {
      std::unique_lock<std::mutex> lock(s->mu);
      s->cv_space.wait(lock, [s] {
        return s->stop.load() || !s->free_q.empty();
      });
      if (s->stop.load()) return;
      slot_id = s->free_q.front();
      s->free_q.pop_front();
    }

    // Claim a batch worth of indices and its sequence number.
    std::vector<uint64_t> indices;
    uint64_t seq = 0;
    {
      std::lock_guard<std::mutex> lock(s->cursor_mu);
      seq = s->next_claim++;
      for (int64_t i = 0; i < s->batch_size; ++i) {
        if (s->cursor >= s->order.size()) {
          // New epoch: reshuffle.
          std::shuffle(s->order.begin(), s->order.end(), rng);
          s->cursor = 0;
        }
        indices.push_back(s->order[s->cursor++]);
      }
    }

    Store::Slot& slot = s->slots[slot_id];
    slot.count = s->block_hi - s->block_lo;
    slot.seq = seq;
    for (size_t i = 0; i < size_t(slot.count); ++i) {
      copy_chip(s, indices[size_t(s->block_lo) + i],
                slot.x.data() + i * s->x_bytes,
                s->header.has_labels ? slot.y.data() + i * s->y_bytes
                                     : nullptr,
                s->header.has_labels ? slot.bdist.data() + i * s->bdist_bytes
                                     : nullptr,
                slot.meta.data() + i * s->meta_bytes);
    }

    std::unique_lock<std::mutex> lock(s->mu);
    if (s->stop.load()) return;
    s->ready.push_back(slot_id);
    s->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* cs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mapped = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mapped == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->data = static_cast<const uint8_t*>(mapped);
  s->file_size = size_t(st.st_size);
  std::memcpy(&s->header, s->data, sizeof(Header));
  const Header& h = s->header;
  if (std::memcmp(h.magic, "CTS1", 4) != 0 ||
      (h.version != 1 && h.version != 2)) {
    munmap(mapped, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  const size_t x_elem = h.version == 2 ? sizeof(int16_t) : sizeof(float);
  const size_t y_elem = h.version == 2 ? sizeof(int16_t) : sizeof(int32_t);
  const size_t b_elem = h.version == 2 ? sizeof(int16_t) : sizeof(float);
  s->x_bytes = size_t(h.t) * h.h * h.w * h.c * x_elem;
  s->y_bytes = h.has_labels ? size_t(h.h) * h.w * y_elem : 0;
  s->bdist_bytes = h.has_labels ? size_t(h.h) * h.w * b_elem : 0;
  s->record_bytes = s->x_bytes + s->y_bytes + s->bdist_bytes + s->meta_bytes;
  return s;
}

int64_t cs_num_chips(void* handle) {
  return int64_t(static_cast<Store*>(handle)->header.num_chips);
}

void cs_dims(void* handle, uint32_t* dims_out) {
  const Header& h = static_cast<Store*>(handle)->header;
  dims_out[0] = h.t;
  dims_out[1] = h.h;
  dims_out[2] = h.w;
  dims_out[3] = h.c;
  dims_out[4] = h.has_labels;
}

uint32_t cs_version(void* handle) {
  return static_cast<Store*>(handle)->header.version;
}

// Synchronous batched read of explicit indices. Buffers are raw bytes typed
// per the store version (query cs_version / cs_dims from the caller).
int cs_read_batch(void* handle, const int64_t* indices, int64_t n,
                  void* x_out, void* y_out, void* bdist_out, void* meta_out) {
  auto* s = static_cast<Store*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t chip = uint64_t(indices[i]);
    if (chip >= s->header.num_chips) return -1;
    copy_chip(
        s, chip, static_cast<uint8_t*>(x_out) + size_t(i) * s->x_bytes,
        y_out ? static_cast<uint8_t*>(y_out) + size_t(i) * s->y_bytes
              : nullptr,
        bdist_out
            ? static_cast<uint8_t*>(bdist_out) + size_t(i) * s->bdist_bytes
            : nullptr,
        meta_out ? static_cast<uint8_t*>(meta_out) + size_t(i) * s->meta_bytes
                 : nullptr);
  }
  return 0;
}

// Background prefetch pipeline: shuffled epochs, zero-copy slot ring. Each
// slot holds the rows [lo, hi) of a shuffled batch of batch_size chips.
int cs_prefetch_start_block(void* handle, int64_t batch_size, int64_t lo,
                            int64_t hi, uint64_t seed, int num_threads,
                            int num_slots) {
  auto* s = static_cast<Store*>(handle);
  if (s->running || batch_size <= 0 || lo < 0 || hi <= lo || hi > batch_size)
    return -1;
  s->batch_size = batch_size;
  s->block_lo = lo;
  s->block_hi = hi;
  const size_t rows = size_t(hi - lo);
  s->order.resize(s->header.num_chips);
  for (uint64_t i = 0; i < s->header.num_chips; ++i) s->order[i] = i;
  std::mt19937_64 rng(seed);
  std::shuffle(s->order.begin(), s->order.end(), rng);
  s->cursor = 0;
  s->next_claim = 0;
  s->next_deliver = 0;
  s->stop.store(false);

  int slots = num_slots > 0 ? num_slots : 4;
  s->slots.assign(size_t(slots), Store::Slot{});
  s->ready.clear();
  s->free_q.clear();
  for (int i = 0; i < slots; ++i) {
    auto& slot = s->slots[i];
    slot.x.resize(rows * s->x_bytes);
    slot.meta.resize(rows * s->meta_bytes);
    if (s->header.has_labels) {
      slot.y.resize(rows * s->y_bytes);
      slot.bdist.resize(rows * s->bdist_bytes);
    }
    s->free_q.push_back(i);
  }

  int threads = num_threads > 0 ? num_threads : 2;
  for (int t = 0; t < threads; ++t) {
    s->workers.emplace_back(worker_loop, s, seed + 1 + uint64_t(t));
  }
  s->running = true;
  return 0;
}

// Blocking: returns the slot that holds the next batch in claim order
// (zero-copy: map its pointers with cs_slot_ptrs, release with
// cs_release_slot when consumed).
int64_t cs_next_slot(void* handle, int64_t* count_out) {
  auto* s = static_cast<Store*>(handle);
  std::unique_lock<std::mutex> lock(s->mu);
  auto next = s->ready.end();
  s->cv_ready.wait(lock, [s, &next] {
    next = std::find_if(s->ready.begin(), s->ready.end(), [s](int id) {
      return s->slots[size_t(id)].seq == s->next_deliver;
    });
    return s->stop.load() || next != s->ready.end();
  });
  if (next == s->ready.end()) return -1;
  int slot_id = *next;
  s->ready.erase(next);
  ++s->next_deliver;
  if (count_out) *count_out = s->slots[slot_id].count;
  return slot_id;
}

void cs_slot_ptrs(void* handle, int64_t slot_id, void** ptrs_out) {
  auto* s = static_cast<Store*>(handle);
  auto& slot = s->slots[size_t(slot_id)];
  ptrs_out[0] = slot.x.data();
  ptrs_out[1] = slot.y.empty() ? nullptr : slot.y.data();
  ptrs_out[2] = slot.bdist.empty() ? nullptr : slot.bdist.data();
  ptrs_out[3] = slot.meta.data();
}

void cs_release_slot(void* handle, int64_t slot_id) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  s->free_q.push_back(int(slot_id));
  s->cv_space.notify_one();
}

void cs_prefetch_stop(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s->running) return;
  s->stop.store(true);
  s->cv_ready.notify_all();
  s->cv_space.notify_all();
  for (auto& t : s->workers) t.join();
  s->workers.clear();
  s->ready.clear();
  s->free_q.clear();
  s->slots.clear();
  s->running = false;
}

void cs_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  cs_prefetch_stop(s);
  if (s->data) munmap(const_cast<uint8_t*>(s->data), s->file_size);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

}  // extern "C"

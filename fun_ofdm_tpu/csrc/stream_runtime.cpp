// fun_ofdm_tpu native streaming runtime.
//
// Host-side equivalent of the reference's native runtime layer: the
// semaphore-driven sample transport of usrp.cpp (send_burst/get_samples,
// reference src/usrp.cpp:91-130) and the carryover/buffer-swap machinery of
// receiver_chain.cpp (reference src/receiver_chain.cpp:106-126,
// src/timing_sync.cpp:134-137). Two primitives:
//
//   * ring   — blocking bounded FIFO of planar (re, im) float32 samples with
//              close semantics. Used as the loopback "radio" bus between
//              Transmitter and Receiver (usrp send/recv equivalent) and as
//              the Receiver's ingest queue, so host sample I/O overlaps
//              device compute exactly like the reference's RX thread
//              overlaps its block threads.
//   * chunker — overlap-save window assembler: accepts arbitrary-length
//              sample runs and emits fixed-size windows that advance by a
//              fixed stride, retaining a halo of history so frames that
//              straddle chunk boundaries decode whole (the native
//              generalization of the reference's per-stage carryover
//              buffers). Fixed window shapes mean one XLA specialization.
//
// Everything is C ABI (extern "C") and loaded from Python via ctypes; the
// device compute path stays in JAX/XLA/Pallas.

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Ring {
  std::vector<float> re, im;
  size_t cap = 0;
  size_t head = 0;  // read position
  size_t count = 0; // samples available
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
};

struct Chunker {
  std::vector<float> re, im; // pending samples (planar)
  size_t stride = 0;         // owned samples consumed per window
  size_t window = 0;         // total samples returned per pop (stride+halo)
  uint64_t pos = 0;          // global stream position of pending[0]
};

} // namespace

extern "C" {

// ---------------------------------------------------------------- ring ----

void *ring_create(size_t capacity) {
  Ring *r = new Ring();
  r->cap = capacity;
  r->re.resize(capacity);
  r->im.resize(capacity);
  return r;
}

void ring_destroy(void *h) { delete static_cast<Ring *>(h); }

size_t ring_size(void *h) {
  Ring *r = static_cast<Ring *>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  return r->count;
}

void ring_close(void *h) {
  Ring *r = static_cast<Ring *>(h);
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->closed = true;
  }
  r->not_empty.notify_all();
  r->not_full.notify_all();
}

// Push n planar samples. blocking=1: wait for space (returns n, or the
// count written before close). blocking=0: write what fits, return count.
//
// Blocking pushes reserve capacity for the WHOLE remaining burst (capped at
// ring capacity) before copying, so a concurrent non-blocking pop can never
// observe a half-written burst and splice zero-fill into the middle of a
// frame (bursts larger than the ring degrade to capacity-sized atomic
// chunks — callers should size the ring above their largest burst).
size_t ring_push(void *h, const float *sre, const float *sim, size_t n,
                 int blocking) {
  Ring *r = static_cast<Ring *>(h);
  size_t written = 0;
  std::unique_lock<std::mutex> lk(r->mu);
  while (written < n) {
    if (r->closed)
      break;
    size_t need = std::min(n - written, r->cap);
    size_t space = r->cap - r->count;
    if (blocking ? (space < need) : (space == 0)) {
      if (!blocking)
        break;
      r->not_full.wait(
          lk, [&] { return r->cap - r->count >= need || r->closed; });
      continue;
    }
    size_t take = std::min(space, n - written);
    size_t w = (r->head + r->count) % r->cap;
    size_t first = std::min(take, r->cap - w);
    std::memcpy(&r->re[w], sre + written, first * sizeof(float));
    std::memcpy(&r->im[w], sim + written, first * sizeof(float));
    if (take > first) {
      std::memcpy(&r->re[0], sre + written + first,
                  (take - first) * sizeof(float));
      std::memcpy(&r->im[0], sim + written + first,
                  (take - first) * sizeof(float));
    }
    r->count += take;
    written += take;
    r->not_empty.notify_all();
  }
  return written;
}

// Pop up to n planar samples. blocking=1: wait until n samples are
// available (or the ring is closed — then drain what remains). Returns the
// count actually popped.
size_t ring_pop(void *h, float *dre, float *dim, size_t n, int blocking) {
  Ring *r = static_cast<Ring *>(h);
  size_t read = 0;
  std::unique_lock<std::mutex> lk(r->mu);
  while (read < n) {
    if (r->count == 0) {
      if (r->closed || !blocking)
        break;
      r->not_empty.wait(lk, [&] { return r->count > 0 || r->closed; });
      continue;
    }
    size_t take = std::min(r->count, n - read);
    size_t first = std::min(take, r->cap - r->head);
    std::memcpy(dre + read, &r->re[r->head], first * sizeof(float));
    std::memcpy(dim + read, &r->im[r->head], first * sizeof(float));
    if (take > first) {
      std::memcpy(dre + read + first, &r->re[0],
                  (take - first) * sizeof(float));
      std::memcpy(dim + read + first, &r->im[0],
                  (take - first) * sizeof(float));
    }
    r->head = (r->head + take) % r->cap;
    r->count -= take;
    read += take;
    r->not_full.notify_all();
  }
  return read;
}

// Pop up to n planar samples, waiting at most timeout_ms for them to
// arrive (the radio-sample-clock pop: a real receiver blocks on its
// stream's recv timeout, reference src/usrp.cpp:125-130). Returns the
// count actually popped — short only on timeout or close.
size_t ring_pop_timeout(void *h, float *dre, float *dim, size_t n,
                        double timeout_ms) {
  Ring *r = static_cast<Ring *>(h);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                      std::chrono::duration<double, std::milli>(timeout_ms));
  size_t read = 0;
  std::unique_lock<std::mutex> lk(r->mu);
  while (read < n) {
    if (r->count == 0) {
      if (r->closed)
        break;
      if (!r->not_empty.wait_until(
              lk, deadline, [&] { return r->count > 0 || r->closed; }))
        break; // timed out
      continue;
    }
    size_t take = std::min(r->count, n - read);
    size_t first = std::min(take, r->cap - r->head);
    std::memcpy(dre + read, &r->re[r->head], first * sizeof(float));
    std::memcpy(dim + read, &r->im[r->head], first * sizeof(float));
    if (take > first) {
      std::memcpy(dre + read + first, &r->re[0],
                  (take - first) * sizeof(float));
      std::memcpy(dim + read + first, &r->im[0],
                  (take - first) * sizeof(float));
    }
    r->head = (r->head + take) % r->cap;
    r->count -= take;
    read += take;
    r->not_full.notify_all();
  }
  return read;
}

// ------------------------------------------------------------- chunker ----

// window = stride + halo: each pop returns `window` samples starting at the
// current owned position and then advances by `stride`; the trailing halo
// samples are re-presented in the next window.
void *chunker_create(size_t stride, size_t window) {
  Chunker *c = new Chunker();
  c->stride = stride;
  c->window = window;
  return c;
}

void chunker_destroy(void *h) { delete static_cast<Chunker *>(h); }

void chunker_push(void *h, const float *sre, const float *sim, size_t n) {
  Chunker *c = static_cast<Chunker *>(h);
  c->re.insert(c->re.end(), sre, sre + n);
  c->im.insert(c->im.end(), sim, sim + n);
}

// Samples buffered beyond the current owned position.
size_t chunker_available(void *h) {
  return static_cast<Chunker *>(h)->re.size();
}

// 1 if a full window can be popped.
int chunker_ready(void *h) {
  Chunker *c = static_cast<Chunker *>(h);
  return c->re.size() >= c->window ? 1 : 0;
}

// Pop one window. pad=1 zero-fills a short tail (flush); returns the global
// stream position of window[0], or -1 if not ready (and pad=0) or empty.
int64_t chunker_pop(void *h, float *dre, float *dim, int pad) {
  Chunker *c = static_cast<Chunker *>(h);
  size_t have = c->re.size();
  if (have < c->window && (!pad || have == 0))
    return -1;
  size_t n = std::min(have, c->window);
  std::memcpy(dre, c->re.data(), n * sizeof(float));
  std::memcpy(dim, c->im.data(), n * sizeof(float));
  if (n < c->window) {
    std::memset(dre + n, 0, (c->window - n) * sizeof(float));
    std::memset(dim + n, 0, (c->window - n) * sizeof(float));
  }
  int64_t pos = static_cast<int64_t>(c->pos);
  size_t adv = std::min(c->stride, have);
  c->re.erase(c->re.begin(), c->re.begin() + adv);
  c->im.erase(c->im.begin(), c->im.begin() + adv);
  c->pos += adv;
  return pos;
}

} // extern "C"

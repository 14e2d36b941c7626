// Native IQ ingest runtime: lock-free ring buffer + wire-format
// conversion + UDP/file producers.
//
// Fills the role of the reference's C++ transport layer on the sample
// path — gr-osmosdr/UHD driver callbacks, zeromq.pub_sink/sub_source
// fan-out, and the legacy blocks.udp_source (reference
// rc_frontend/receiver.py:201-202, receiver.py:91-92: 147200-byte UDP
// payloads, 1.25 MB socket buffers). SDR drivers or network feeds push
// int8/int16/float32 IQ into a single-producer single-consumer ring on
// their own thread; the Python site runtime pops fixed-size blocks
// already converted to the float32 re/im wire layout the device pipelines
// ingest (SURVEY.md §7 hard part 5: ingest bandwidth, int8/int16 on the
// wire). No locks on the hot path; conversion happens on the consumer
// side at pop time so the ring stores the compact wire format.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

namespace {

enum Format : int32_t {
  FMT_CF32 = 0,   // interleaved float32 I,Q
  FMT_CS16 = 1,   // interleaved int16 I,Q  (rtl_tcp/UHD sc16 wire)
  FMT_CS8 = 2,    // interleaved int8 I,Q   (rtl-sdr native, offset-free)
  FMT_CU8 = 3,    // interleaved uint8 I,Q  (rtl-sdr raw, 127.5 offset)
};

size_t bytes_per_sample(int32_t fmt) {
  switch (fmt) {
    case FMT_CF32: return 8;
    case FMT_CS16: return 4;
    case FMT_CS8:  return 2;
    case FMT_CU8:  return 2;
  }
  return 0;
}

struct Ring {
  uint8_t* buf = nullptr;
  size_t capacity = 0;           // bytes, power of two
  std::atomic<uint64_t> head{0};  // producer bytes written
  std::atomic<uint64_t> tail{0};  // consumer bytes read
  std::atomic<uint64_t> dropped{0};  // samples dropped on overflow
  int32_t fmt = FMT_CF32;
  float scale = 1.0f;

  size_t mask() const { return capacity - 1; }
};

size_t round_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// ---- ring buffer ----

void* rc_ring_create(int32_t fmt, int64_t capacity_samples, float scale) {
  Ring* r = new Ring();
  r->fmt = fmt;
  r->scale = scale;
  r->capacity = round_pow2(
      static_cast<size_t>(capacity_samples) * bytes_per_sample(fmt));
  r->buf = static_cast<uint8_t*>(std::malloc(r->capacity));
  if (!r->buf) { delete r; return nullptr; }
  return r;
}

void rc_ring_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  if (!r) return;
  std::free(r->buf);
  delete r;
}

int64_t rc_ring_available(void* h) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  return static_cast<int64_t>((head - tail) / bytes_per_sample(r->fmt));
}

int64_t rc_ring_dropped(void* h) {
  return static_cast<Ring*>(h)->dropped.load(std::memory_order_relaxed);
}

// Producer: push n_samples of wire-format IQ. On overflow the INCOMING
// tail of the write is dropped (and counted): the producer never mutates
// `tail`, so a concurrent pop can never observe torn bytes or rewound
// accounting. A stalled consumer therefore never stalls the SDR driver
// thread — the same back-pressure-free semantics the reference gets from
// finite kernel/ZMQ socket buffers, which likewise drop the newest
// datagrams when full (reference receiver.py:91-92).
int64_t rc_ring_push(void* h, const void* data, int64_t n_samples) {
  Ring* r = static_cast<Ring*>(h);
  const size_t bps = bytes_per_sample(r->fmt);
  size_t nbytes = static_cast<size_t>(n_samples) * bps;
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_b = r->capacity - static_cast<size_t>(head - tail);
  if (nbytes > free_b) {
    size_t fit = (free_b / bps) * bps;  // whole samples only
    r->dropped.fetch_add((nbytes - fit) / bps, std::memory_order_relaxed);
    nbytes = fit;
    if (nbytes == 0) return 0;
  }
  size_t off = static_cast<size_t>(head) & r->mask();
  size_t first = r->capacity - off;
  if (first > nbytes) first = nbytes;
  std::memcpy(r->buf + off, data, first);
  if (nbytes > first)
    std::memcpy(r->buf, static_cast<const uint8_t*>(data) + first,
                nbytes - first);
  r->head.store(head + nbytes, std::memory_order_release);
  return static_cast<int64_t>(nbytes / bps);  // samples accepted
}

// Consumer: pop exactly n_samples converted to float32 re/im pairs into
// out[n_samples*2]. Returns n_samples, or 0 if not enough buffered.
int64_t rc_ring_pop_f32(void* h, float* out, int64_t n_samples) {
  Ring* r = static_cast<Ring*>(h);
  const size_t bps = bytes_per_sample(r->fmt);
  const size_t nbytes = static_cast<size_t>(n_samples) * bps;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (head - tail < nbytes) return 0;
  const float scale = r->scale;
  size_t off = static_cast<size_t>(tail) & r->mask();
  // Gather possibly-wrapped bytes through a small stack window.
  for (int64_t i = 0; i < n_samples; ++i) {
    uint8_t tmp[8];
    for (size_t b = 0; b < bps; ++b)
      tmp[b] = r->buf[(off + i * bps + b) & r->mask()];
    float re, im;
    switch (r->fmt) {
      case FMT_CF32: {
        float v[2];
        std::memcpy(v, tmp, 8);
        re = v[0]; im = v[1];
        break;
      }
      case FMT_CS16: {
        int16_t v[2];
        std::memcpy(v, tmp, 4);
        re = v[0] * (1.0f / 32768.0f); im = v[1] * (1.0f / 32768.0f);
        break;
      }
      case FMT_CS8: {
        int8_t v[2];
        std::memcpy(v, tmp, 2);
        re = v[0] * (1.0f / 128.0f); im = v[1] * (1.0f / 128.0f);
        break;
      }
      default: {  // FMT_CU8
        re = (tmp[0] - 127.5f) * (1.0f / 127.5f);
        im = (tmp[1] - 127.5f) * (1.0f / 127.5f);
        break;
      }
    }
    out[2 * i] = re * scale;
    out[2 * i + 1] = im * scale;
  }
  r->tail.store(tail + nbytes, std::memory_order_release);
  return n_samples;
}

// float -> bfloat16 (round to nearest even), bit pattern as uint16.
static inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  x += 0x7fffu + ((x >> 16) & 1u);
  return static_cast<uint16_t>(x >> 16);
}

// Consumer: pop exactly n_samples converted to bfloat16 re/im pairs —
// half the bytes of float32. Lossless for the 8-bit SDR wire
// formats (cu8/cs8 carry 8 significant bits; bf16 has an 8-bit
// mantissa) and halves the host->device stream vs float32.
int64_t rc_ring_pop_bf16(void* h, uint16_t* out, int64_t n_samples) {
  Ring* r = static_cast<Ring*>(h);
  const size_t bps = bytes_per_sample(r->fmt);
  const size_t nbytes = static_cast<size_t>(n_samples) * bps;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (head - tail < nbytes) return 0;
  const float scale = r->scale;
  size_t off = static_cast<size_t>(tail) & r->mask();
  for (int64_t i = 0; i < n_samples; ++i) {
    uint8_t tmp[8];
    for (size_t b = 0; b < bps; ++b)
      tmp[b] = r->buf[(off + i * bps + b) & r->mask()];
    float re, im;
    switch (r->fmt) {
      case FMT_CF32: {
        float v[2];
        std::memcpy(v, tmp, 8);
        re = v[0]; im = v[1];
        break;
      }
      case FMT_CS16: {
        int16_t v[2];
        std::memcpy(v, tmp, 4);
        re = v[0] * (1.0f / 32768.0f); im = v[1] * (1.0f / 32768.0f);
        break;
      }
      case FMT_CS8: {
        int8_t v[2];
        std::memcpy(v, tmp, 2);
        re = v[0] * (1.0f / 128.0f); im = v[1] * (1.0f / 128.0f);
        break;
      }
      default: {  // FMT_CU8
        re = (tmp[0] - 127.5f) * (1.0f / 127.5f);
        im = (tmp[1] - 127.5f) * (1.0f / 127.5f);
        break;
      }
    }
    out[2 * i] = f32_to_bf16(re * scale);
    out[2 * i + 1] = f32_to_bf16(im * scale);
  }
  r->tail.store(tail + nbytes, std::memory_order_release);
  return n_samples;
}

// ---- UDP producer (legacy transport: receiver.py:91-92) ----
// Blocking receive loop intended for a dedicated thread: reads datagrams
// into the ring until rc_udp_stop. Returns the socket fd or -1.

struct UdpCtx {
  int fd = -1;
  std::atomic<bool> running{false};
};

void* rc_udp_open(const char* bind_addr, int port, int rcvbuf) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  if (rcvbuf > 0)
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  struct timeval tv = {0, 200000};  // 200 ms poll so stop is prompt
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = bind_addr && *bind_addr
      ? inet_addr(bind_addr) : INADDR_ANY;
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    return nullptr;
  }
  UdpCtx* c = new UdpCtx();
  c->fd = fd;
  c->running.store(true);
  return c;
}

// Run on a dedicated (Python threading) thread; returns on rc_udp_stop.
int64_t rc_udp_pump(void* uctx, void* ring, int64_t max_datagram) {
  UdpCtx* c = static_cast<UdpCtx*>(uctx);
  Ring* r = static_cast<Ring*>(ring);
  const size_t bps = bytes_per_sample(r->fmt);
  if (max_datagram <= 0) max_datagram = 65536;
  uint8_t* tmp = static_cast<uint8_t*>(std::malloc(max_datagram));
  int64_t total = 0;
  while (c->running.load(std::memory_order_relaxed)) {
    ssize_t got = recv(c->fd, tmp, max_datagram, 0);
    if (got <= 0) continue;  // timeout poll
    int64_t n = got / static_cast<int64_t>(bps);
    if (n > 0) total += rc_ring_push(r, tmp, n);
  }
  std::free(tmp);
  return total;
}

void rc_udp_stop(void* uctx) {
  static_cast<UdpCtx*>(uctx)->running.store(false);
}

void rc_udp_close(void* uctx) {
  UdpCtx* c = static_cast<UdpCtx*>(uctx);
  close(c->fd);
  delete c;
}

}  // extern "C"

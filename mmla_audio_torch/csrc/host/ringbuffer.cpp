// Lock-free SPSC ring buffer for PCM capture.
//
// The reference's capture layer is PyAudio blocking reads inside the Python
// hot loop (record_on_pc.py:115-124); dropped buffers are silently swallowed
// (exception_on_overflow=False, record_on_pi.py:85).  Here capture runs on
// its own (native or Python) producer thread pushing int16 samples into this
// buffer, and the session thread pops fixed-size windows to feed the device.
// Single-producer/single-consumer with acquire/release atomics -- no locks in
// the audio path; overrun/underrun accounting is explicit (SURVEY §5 failure
// detection note).
//
// C ABI so Python binds with ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

struct RingBuffer {
    int16_t* data;
    uint64_t capacity;          // power of two
    std::atomic<uint64_t> head; // write position (producer)
    std::atomic<uint64_t> tail; // read position (consumer)
    std::atomic<uint64_t> overruns;   // samples dropped on push
    std::atomic<uint64_t> underruns;  // pops that found too little data
};

static uint64_t round_up_pow2(uint64_t v) {
    uint64_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

RingBuffer* rb_create(uint64_t capacity_samples) {
    auto* rb = new (std::nothrow) RingBuffer();
    if (!rb) return nullptr;
    rb->capacity = round_up_pow2(capacity_samples);
    rb->data = new (std::nothrow) int16_t[rb->capacity];
    if (!rb->data) { delete rb; return nullptr; }
    rb->head.store(0);
    rb->tail.store(0);
    rb->overruns.store(0);
    rb->underruns.store(0);
    return rb;
}

void rb_destroy(RingBuffer* rb) {
    if (!rb) return;
    delete[] rb->data;
    delete rb;
}

uint64_t rb_capacity(const RingBuffer* rb) { return rb->capacity; }

uint64_t rb_available(const RingBuffer* rb) {
    return rb->head.load(std::memory_order_acquire) -
           rb->tail.load(std::memory_order_acquire);
}

uint64_t rb_overruns(const RingBuffer* rb) { return rb->overruns.load(); }
uint64_t rb_underruns(const RingBuffer* rb) { return rb->underruns.load(); }

// Producer: push n samples; drops the excess (and counts it) when full.
// Returns samples actually written.
uint64_t rb_push(RingBuffer* rb, const int16_t* src, uint64_t n) {
    const uint64_t head = rb->head.load(std::memory_order_relaxed);
    const uint64_t tail = rb->tail.load(std::memory_order_acquire);
    const uint64_t free_space = rb->capacity - (head - tail);
    const uint64_t to_write = n < free_space ? n : free_space;
    if (to_write < n) rb->overruns.fetch_add(n - to_write);
    const uint64_t mask = rb->capacity - 1;
    uint64_t pos = head & mask;
    const uint64_t first = to_write < (rb->capacity - pos) ? to_write
                                                           : (rb->capacity - pos);
    std::memcpy(rb->data + pos, src, first * sizeof(int16_t));
    if (to_write > first)
        std::memcpy(rb->data, src + first, (to_write - first) * sizeof(int16_t));
    rb->head.store(head + to_write, std::memory_order_release);
    return to_write;
}

// Consumer: pop exactly n samples if available, else nothing (returns 0 and
// counts an underrun) -- sessions want whole windows.
uint64_t rb_pop(RingBuffer* rb, int16_t* dst, uint64_t n) {
    const uint64_t head = rb->head.load(std::memory_order_acquire);
    const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
    if (head - tail < n) {
        rb->underruns.fetch_add(1);
        return 0;
    }
    const uint64_t mask = rb->capacity - 1;
    uint64_t pos = tail & mask;
    const uint64_t first = n < (rb->capacity - pos) ? n : (rb->capacity - pos);
    std::memcpy(dst, rb->data + pos, first * sizeof(int16_t));
    if (n > first)
        std::memcpy(dst + first, rb->data, (n - first) * sizeof(int16_t));
    rb->tail.store(tail + n, std::memory_order_release);
    return n;
}

// Consumer: pop up to n samples (drain on shutdown).
uint64_t rb_pop_upto(RingBuffer* rb, int16_t* dst, uint64_t n) {
    const uint64_t head = rb->head.load(std::memory_order_acquire);
    const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
    const uint64_t avail = head - tail;
    const uint64_t to_read = n < avail ? n : avail;
    if (to_read == 0) return 0;
    const uint64_t mask = rb->capacity - 1;
    uint64_t pos = tail & mask;
    const uint64_t first = to_read < (rb->capacity - pos) ? to_read
                                                          : (rb->capacity - pos);
    std::memcpy(dst, rb->data + pos, first * sizeof(int16_t));
    if (to_read > first)
        std::memcpy(dst + first, rb->data, (to_read - first) * sizeof(int16_t));
    rb->tail.store(tail + to_read, std::memory_order_release);
    return to_read;
}

void rb_clear(RingBuffer* rb) {
    rb->tail.store(rb->head.load(std::memory_order_acquire),
                   std::memory_order_release);
}

// Batched consumer for the multi-stream multiplexer: poll every ring once
// (starting at `start`, wrapping, skipping rings with active[i] == 0) and
// pop one whole n_win-sample window from each ready ring directly into the
// rows of the int16 staging matrix `dst` (row-major, n_win columns),
// beginning at row `row0`.  Ring indices of the popped rows go to
// `indices[0..popped)`.  Stops after `limit` pops.  Returns pops.
//
// One ctypes call replaces N per-stream Python polls + N row copies — the
// host gather cost of a tick becomes a single C loop over memcpys
// (VERDICT r2 item 3).  SPSC safety: this is the consumer side, called only
// from the serving thread.
uint64_t rb_pop_batch(RingBuffer** rings, uint64_t n_rings, uint64_t start,
                      const uint8_t* active, uint64_t limit, uint64_t n_win,
                      int16_t* dst, uint64_t row0, int32_t* indices) {
    uint64_t popped = 0;
    for (uint64_t k = 0; k < n_rings && popped < limit; ++k) {
        const uint64_t i = (start + k) % n_rings;
        if (!active[i]) continue;
        RingBuffer* rb = rings[i];
        const uint64_t head = rb->head.load(std::memory_order_acquire);
        const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
        if (head - tail < n_win) continue;
        const uint64_t mask = rb->capacity - 1;
        const uint64_t pos = tail & mask;
        const uint64_t first = n_win < (rb->capacity - pos)
                                   ? n_win : (rb->capacity - pos);
        int16_t* row = dst + (row0 + popped) * n_win;
        std::memcpy(row, rb->data + pos, first * sizeof(int16_t));
        if (n_win > first)
            std::memcpy(row + first, rb->data, (n_win - first) * sizeof(int16_t));
        rb->tail.store(tail + n_win, std::memory_order_release);
        indices[popped] = (int32_t)i;
        ++popped;
    }
    return popped;
}

}  // extern "C"

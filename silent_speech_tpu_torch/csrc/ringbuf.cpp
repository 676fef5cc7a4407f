// Lock-free single-producer/single-consumer frame ring buffer (the port's
// copy of the repository's csrc/ringbuf.cpp; runtime/native.py builds it
// with g++).
//
// The live pipeline's capture/landmark thread produces per-frame payloads
// (feature vector + ROI bytes) while the dispatch thread consumes batches to
// feed the device. The reference has no such component (its loop is
// single-threaded, SURVEY.md section 5); this is the host-side runtime piece
// that lets MediaPipe latency overlap with the device's dispatch.
//
// Design: fixed-capacity power-of-two slot array, each slot a fixed-size
// record (header + payload). Producer writes then publishes by storing the
// head index with release ordering; consumer reads with acquire ordering.
// Overwrite-oldest semantics are NOT used — push fails when full so the
// producer can drop frames deliberately (matching the reference's
// drop-on-gate behavior rather than silently corrupting clips).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

struct RingBuf {
    uint64_t capacity;      // number of slots, power of two
    uint64_t slot_bytes;    // payload bytes per slot
    std::atomic<uint64_t> head;  // next write index (producer-owned)
    std::atomic<uint64_t> tail;  // next read index (consumer-owned)
    std::atomic<uint64_t> dropped;  // producer-side full-drop counter
    uint8_t* data;
    uint64_t* stamps;       // per-slot user timestamp (e.g. ms)
};

static uint64_t next_pow2(uint64_t v) {
    if (v < 2) return 2;
    v--;
    for (unsigned s = 1; s < 64; s <<= 1) v |= v >> s;
    return v + 1;
}

RingBuf* rb_create(uint64_t capacity, uint64_t slot_bytes) {
    RingBuf* rb = new (std::nothrow) RingBuf();
    if (!rb) return nullptr;
    rb->capacity = next_pow2(capacity);
    rb->slot_bytes = slot_bytes;
    rb->head.store(0, std::memory_order_relaxed);
    rb->tail.store(0, std::memory_order_relaxed);
    rb->dropped.store(0, std::memory_order_relaxed);
    rb->data = new (std::nothrow) uint8_t[rb->capacity * slot_bytes];
    rb->stamps = new (std::nothrow) uint64_t[rb->capacity];
    if (!rb->data || !rb->stamps) {
        delete[] rb->data;
        delete[] rb->stamps;
        delete rb;
        return nullptr;
    }
    return rb;
}

void rb_destroy(RingBuf* rb) {
    if (!rb) return;
    delete[] rb->data;
    delete[] rb->stamps;
    delete rb;
}

uint64_t rb_capacity(const RingBuf* rb) { return rb->capacity; }
uint64_t rb_slot_bytes(const RingBuf* rb) { return rb->slot_bytes; }

uint64_t rb_size(const RingBuf* rb) {
    // tail FIRST, then head: a third-thread observer that read head first
    // could see a pop+push land in between and compute h_old - t_new < 0,
    // wrapping to ~2^64. Reading tail first guarantees h >= t for any
    // caller (tail only grows, and head read afterwards is >= the head
    // that produced the observed tail).
    uint64_t t = rb->tail.load(std::memory_order_acquire);
    uint64_t h = rb->head.load(std::memory_order_acquire);
    return h - t;
}

uint64_t rb_dropped(const RingBuf* rb) {
    return rb->dropped.load(std::memory_order_relaxed);
}

// Producer: copy one payload in. Returns 1 on success, 0 when full.
int rb_push(RingBuf* rb, const uint8_t* payload, uint64_t nbytes,
            uint64_t stamp) {
    uint64_t h = rb->head.load(std::memory_order_relaxed);
    uint64_t t = rb->tail.load(std::memory_order_acquire);
    if (h - t >= rb->capacity) {
        rb->dropped.fetch_add(1, std::memory_order_relaxed);
        return 0;
    }
    uint64_t slot = h & (rb->capacity - 1);
    uint64_t n = nbytes < rb->slot_bytes ? nbytes : rb->slot_bytes;
    std::memcpy(rb->data + slot * rb->slot_bytes, payload, n);
    rb->stamps[slot] = stamp;
    rb->head.store(h + 1, std::memory_order_release);
    return 1;
}

// Consumer: copy one payload out. Returns 1 on success, 0 when empty.
int rb_pop(RingBuf* rb, uint8_t* out, uint64_t nbytes, uint64_t* stamp_out) {
    uint64_t t = rb->tail.load(std::memory_order_relaxed);
    uint64_t h = rb->head.load(std::memory_order_acquire);
    if (t == h) return 0;
    uint64_t slot = t & (rb->capacity - 1);
    uint64_t n = nbytes < rb->slot_bytes ? nbytes : rb->slot_bytes;
    std::memcpy(out, rb->data + slot * rb->slot_bytes, n);
    if (stamp_out) *stamp_out = rb->stamps[slot];
    rb->tail.store(t + 1, std::memory_order_release);
    return 1;
}

// Consumer: pop up to max_items contiguous payloads into one buffer.
// Returns the number popped. The batch path the dispatch thread uses to
// drain a window at once.
uint64_t rb_pop_batch(RingBuf* rb, uint8_t* out, uint64_t max_items,
                      uint64_t* stamps_out) {
    uint64_t t = rb->tail.load(std::memory_order_relaxed);
    uint64_t h = rb->head.load(std::memory_order_acquire);
    uint64_t avail = h - t;
    uint64_t n = avail < max_items ? avail : max_items;
    for (uint64_t i = 0; i < n; i++) {
        uint64_t slot = (t + i) & (rb->capacity - 1);
        std::memcpy(out + i * rb->slot_bytes,
                    rb->data + slot * rb->slot_bytes, rb->slot_bytes);
        if (stamps_out) stamps_out[i] = rb->stamps[slot];
    }
    rb->tail.store(t + n, std::memory_order_release);
    return n;
}

}  // extern "C"

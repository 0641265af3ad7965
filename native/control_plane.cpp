// Wait-free control-plane primitives for the real-time host integration.
//
// The reference (oddio) is sans-I/O: its audio thread communicates with the
// control thread exclusively through wait-free lock-free structures —
// a bounded SPSC ring channel (src/spsc.rs) and a last-value-wins triple
// buffer (src/swap.rs).  In this rebuild the *device* control plane is
// parameter arrays, but the host-side real-time integration (audio-callback
// thread consuming rendered blocks; game thread publishing control values)
// still needs the same wait-free machinery.  This file provides it as a
// small C ABI used from Python via ctypes (and usable directly from C/C++
// audio callbacks).
//
// Progress guarantees match the reference: no locks, no allocation after
// construction, no unbounded CAS loops — single producer / single consumer
// for the ring (spsc.rs:11-19 semantics: partial writes return the count
// consumed), single writer / single reader for the triple buffer
// (swap.rs:11-27: the reader always observes the most recently flushed
// value; FRESH bit protocol as in swap.rs:79-105).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

struct SpscRing {
    size_t capacity;  // number of floats
    std::atomic<uint64_t> head;  // next write position (monotonic)
    std::atomic<uint64_t> tail;  // next read position (monotonic)
    float* data;
};

struct TripleBuffer {
    size_t payload;           // bytes per slot
    std::atomic<uint32_t> state;  // bits 0-1: shared slot index, bit 2: FRESH
    uint32_t write_slot;      // sender-owned
    uint32_t read_slot;       // receiver-owned
    unsigned char* slots;     // 3 * payload
};

constexpr uint32_t FRESH_BIT = 4u;
constexpr uint32_t INDEX_MASK = 3u;

}  // namespace

extern "C" {

// --- SPSC ring (spsc.rs semantics) ------------------------------------------

SpscRing* oddio_ring_new(size_t capacity) {
    auto* r = new (std::nothrow) SpscRing();
    if (!r) return nullptr;
    r->capacity = capacity;
    r->head.store(0, std::memory_order_relaxed);
    r->tail.store(0, std::memory_order_relaxed);
    r->data = static_cast<float*>(std::malloc(capacity * sizeof(float)));
    if (!r->data) { delete r; return nullptr; }
    return r;
}

void oddio_ring_free(SpscRing* r) {
    if (!r) return;
    std::free(r->data);
    delete r;
}

size_t oddio_ring_writable(const SpscRing* r) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    return r->capacity - static_cast<size_t>(head - tail);
}

size_t oddio_ring_readable(const SpscRing* r) {
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    return static_cast<size_t>(head - tail);
}

// Producer side; returns the number of samples consumed (partial like
// spsc.rs:29-68 send_from_slice).
size_t oddio_ring_write(SpscRing* r, const float* src, size_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    size_t free_slots = r->capacity - static_cast<size_t>(head - tail);
    if (n > free_slots) n = free_slots;
    for (size_t i = 0; i < n; ++i) {
        r->data[(head + i) % r->capacity] = src[i];
    }
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Consumer side; returns the number of samples read.
size_t oddio_ring_read(SpscRing* r, float* dst, size_t n) {
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    size_t avail = static_cast<size_t>(head - tail);
    if (n > avail) n = avail;
    for (size_t i = 0; i < n; ++i) {
        dst[i] = r->data[(tail + i) % r->capacity];
    }
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// --- last-value-wins triple buffer (swap.rs semantics) ------------------------

TripleBuffer* oddio_swap_new(size_t payload_bytes) {
    auto* t = new (std::nothrow) TripleBuffer();
    if (!t) return nullptr;
    t->payload = payload_bytes;
    t->state.store(0, std::memory_order_relaxed);
    t->write_slot = 1;
    t->read_slot = 2;
    t->slots = static_cast<unsigned char*>(std::calloc(3, payload_bytes));
    if (!t->slots) { delete t; return nullptr; }
    return t;
}

void oddio_swap_free(TripleBuffer* t) {
    if (!t) return;
    std::free(t->slots);
    delete t;
}

// Sender: copy payload into the pending slot and flush (swap.rs:36-48).
void oddio_swap_publish(TripleBuffer* t, const void* src) {
    std::memcpy(t->slots + t->write_slot * t->payload, src, t->payload);
    uint32_t prev = t->state.exchange(t->write_slot | FRESH_BIT,
                                      std::memory_order_acq_rel);
    t->write_slot = prev & INDEX_MASK;
}

// Receiver: if a fresh value exists, copy it out and return 1
// (swap.rs:57-68).
int oddio_swap_refresh(TripleBuffer* t, void* dst) {
    uint32_t cur = t->state.load(std::memory_order_relaxed);
    if (cur & FRESH_BIT) {
        uint32_t prev = t->state.exchange(t->read_slot,
                                          std::memory_order_acq_rel);
        t->read_slot = prev & INDEX_MASK;
        std::memcpy(dst, t->slots + t->read_slot * t->payload, t->payload);
        return 1;
    }
    std::memcpy(dst, t->slots + t->read_slot * t->payload, t->payload);
    return 0;
}

}  // extern "C"

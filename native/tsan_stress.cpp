// ThreadSanitizer stress harness for the wait-free control plane.
//
// The reference validated its unsafe lock-free code with Miri in CI
// (reference .github/workflows/rust.yml:75-98).  This rebuild's analogous
// unsafe surface is native/control_plane.cpp; this harness hammers both
// primitives from two threads under TSan:
//
//   g++ -fsanitize=thread -O1 -std=c++17 -o tsan_stress \
//       native/tsan_stress.cpp native/control_plane.cpp -lpthread
//   TSAN_OPTIONS=halt_on_error=1 ./tsan_stress
//
// Exits 0 iff (a) TSan observes no data race and (b) the sequence/tearing
// invariants hold: the ring delivers the exact monotone sample sequence;
// the triple buffer never tears (leading stamp == trailing stamp) and is
// last-value-wins monotone.  tests/test_native.py runs this when a TSan
// runtime is available.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
struct SpscRing;
struct TripleBuffer;
SpscRing* oddio_ring_new(size_t capacity);
void oddio_ring_free(SpscRing*);
size_t oddio_ring_write(SpscRing*, const float*, size_t);
size_t oddio_ring_read(SpscRing*, float*, size_t);
TripleBuffer* oddio_swap_new(size_t payload_bytes);
void oddio_swap_free(TripleBuffer*);
void oddio_swap_publish(TripleBuffer*, const void*);
int oddio_swap_refresh(TripleBuffer*, void*);
}

namespace {

constexpr size_t kRingCap = 1024;
constexpr uint64_t kSamples = 1 << 21;
constexpr uint64_t kPublishes = 1 << 19;
constexpr size_t kPayloadWords = 16;

int ring_stress() {
    SpscRing* r = oddio_ring_new(kRingCap);
    std::atomic<int> fail{0};
    std::thread producer([&] {
        float buf[257];
        uint64_t next = 0;
        while (next < kSamples) {
            size_t want = 1 + (next % 257);
            if (next + want > kSamples) want = kSamples - next;
            for (size_t i = 0; i < want; ++i) buf[i] = float(next + i);
            size_t wrote = oddio_ring_write(r, buf, want);
            next += wrote;
        }
    });
    std::thread consumer([&] {
        float buf[311];
        uint64_t next = 0;
        while (next < kSamples && !fail.load(std::memory_order_relaxed)) {
            size_t got = oddio_ring_read(r, buf, 1 + (next % 311));
            for (size_t i = 0; i < got; ++i) {
                if (buf[i] != float(next + i)) {
                    fail.store(1, std::memory_order_relaxed);
                    break;
                }
            }
            next += got;
        }
    });
    producer.join();
    consumer.join();
    oddio_ring_free(r);
    if (fail.load()) {
        std::fprintf(stderr, "ring: sequence mismatch\n");
        return 1;
    }
    return 0;
}

int swap_stress() {
    TripleBuffer* t = oddio_swap_new(kPayloadWords * sizeof(uint64_t));
    std::atomic<int> done{0};
    std::atomic<int> fail{0};
    std::thread writer([&] {
        uint64_t payload[kPayloadWords];
        for (uint64_t v = 1; v <= kPublishes; ++v) {
            for (size_t i = 0; i < kPayloadWords; ++i) payload[i] = v;
            oddio_swap_publish(t, payload);
        }
        done.store(1, std::memory_order_release);
    });
    std::thread reader([&] {
        uint64_t payload[kPayloadWords];
        uint64_t last = 0;
        while (!done.load(std::memory_order_acquire) &&
               !fail.load(std::memory_order_relaxed)) {
            oddio_swap_refresh(t, payload);
            uint64_t head = payload[0];
            for (size_t i = 1; i < kPayloadWords; ++i) {
                if (payload[i] != head) {
                    std::fprintf(stderr, "swap: torn read %llu vs %llu\n",
                                 (unsigned long long)head,
                                 (unsigned long long)payload[i]);
                    fail.store(1, std::memory_order_relaxed);
                    return;
                }
            }
            if (head < last) {
                std::fprintf(stderr, "swap: went backwards\n");
                fail.store(1, std::memory_order_relaxed);
                return;
            }
            last = head;
        }
    });
    writer.join();
    reader.join();
    oddio_swap_free(t);
    return fail.load() ? 1 : 0;
}

}  // namespace

int main() {
    int rc = ring_stress();
    rc |= swap_stress();
    if (rc == 0) std::puts("tsan_stress ok");
    return rc;
}

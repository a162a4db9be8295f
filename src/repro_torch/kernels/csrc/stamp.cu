// A device stamp: one thread reads the card's %globaltimer (ns) and writes
// it, with its sequence number and the caller's tag, into the next slot of
// a per-device ring. The port's phase spans (repro_torch.utils.spans) place
// one at a phase's start and one at its end, inside a captured round too,
// so every replay times every phase on the device.
//
// Replaces no TPU kernel: the reference's phases are one XLA program whose
// inside no host span sees, and a CUDA graph's replay is the same. Bound on
// the card: one launch (a few microseconds a stamp); the kernel writes 24
// bytes and reads nothing but the counter.
//
// Design: the slot comes from an atomicAdd on a 64-bit counter, so stamps
// of every stream and every graph on the device share one order, and the
// host, which counts the stamps it launches and replays, knows each one's
// sequence number without reading the counter back. A slot holds
// (timer, sequence, tag); a slot overwritten after the ring wrapped shows a
// later sequence number, so a lost stamp is seen, never misread. Stamps
// write nothing else: the work around them gives the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void fl_stamp_kernel(unsigned long long* counter, long long* ring,
                                long long slots, long long tag) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    const unsigned long long seq = atomicAdd(counter, 1ULL);
    long long* slot = ring + 3 * static_cast<long long>(seq % slots);
    slot[0] = static_cast<long long>(now);
    slot[1] = static_cast<long long>(seq);
    slot[2] = tag;
}

}  // namespace

// counter: one uint64 on the device; ring: [slots, 3] int64 on the same
// device. Launches one thread on `stream` and returns cudaGetLastError()
// (0 on success); cudaErrorInvalidValue for a ring of no slots.
extern "C" int stamp_write(void* counter, void* ring, long long slots,
                           long long tag, void* stream) {
    if (slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
    fl_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned long long*>(counter),
        static_cast<long long*>(ring), slots, tag);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stamp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

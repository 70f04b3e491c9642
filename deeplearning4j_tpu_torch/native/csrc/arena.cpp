// Host staging arena: bump allocator over one contiguous block.
//
// TPU-native equivalent of ND4J MemoryWorkspace (SURVEY.md §2.8 item 1 —
// "memory workspaces ... used pervasively, e.g. MultiLayerNetwork.java:
// 1078-1122"). On TPU the device side of workspaces is subsumed by XLA
// buffer donation; what remains is the HOST staging problem: batch arrays
// assembled by the input pipeline should reuse one arena instead of churning
// the Python allocator, so device feeds come from stable, aligned memory.

#include <cstdint>
#include <cstdlib>
#include <new>

namespace {
struct Arena {
    uint8_t* base;
    int64_t capacity;
    int64_t offset;
    int64_t high_water;
};
}  // namespace

extern "C" {

void* dl4j_arena_create(int64_t capacity) {
    void* mem = nullptr;
    if (posix_memalign(&mem, 128, (size_t)capacity) != 0) return nullptr;
    Arena* a = new (std::nothrow) Arena{static_cast<uint8_t*>(mem), capacity, 0, 0};
    if (!a) { free(mem); return nullptr; }
    return a;
}

void dl4j_arena_destroy(void* handle) {
    Arena* a = static_cast<Arena*>(handle);
    if (!a) return;
    free(a->base);
    delete a;
}

// Aligned bump allocation; returns nullptr when the arena is exhausted.
void* dl4j_arena_alloc(void* handle, int64_t size, int64_t align) {
    Arena* a = static_cast<Arena*>(handle);
    if (!a || align <= 0 || (align & (align - 1)) != 0) return nullptr;
    int64_t off = (a->offset + align - 1) & ~(align - 1);
    if (off + size > a->capacity) return nullptr;
    a->offset = off + size;
    if (a->offset > a->high_water) a->high_water = a->offset;
    return a->base + off;
}

// Cycle the workspace: previous allocations are invalidated, memory reused.
void dl4j_arena_reset(void* handle) {
    Arena* a = static_cast<Arena*>(handle);
    if (a) a->offset = 0;
}

int64_t dl4j_arena_used(void* handle) {
    Arena* a = static_cast<Arena*>(handle);
    return a ? a->offset : -1;
}

int64_t dl4j_arena_high_water(void* handle) {
    Arena* a = static_cast<Arena*>(handle);
    return a ? a->high_water : -1;
}

}  // extern "C"

// ThreadSanitizer stress for the threaded VideoHasher: several producer
// rounds pushing frames through a small bounded queue with many workers,
// checking in-order results. Build + run with `make tsan`.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void* hvd_hasher_create(int w, int h, int num_threads, int quality_min);
void hvd_hasher_push(void* hasher, const uint8_t* rgb);
long hvd_hasher_finish(void* hasher);
void hvd_hasher_copy(void* hasher, uint8_t* out);
void hvd_hasher_destroy(void* hasher);
void hvd_pdq_hash_frame(const uint8_t* rgb, int w, int h, uint8_t* out_hash, int* out_quality);
}

int main() {
    const int W = 512, H = 512, FRAMES = 24;
    std::vector<std::vector<uint8_t>> frames;
    unsigned seed = 12345;
    for (int f = 0; f < FRAMES; f++) {
        std::vector<uint8_t> frame((size_t)W * H * 3);
        for (auto& px : frame) {
            seed = seed * 1664525u + 1013904223u;
            px = (uint8_t)(seed >> 24);
        }
        frames.push_back(std::move(frame));
    }

    // reference hashes, single threaded
    std::vector<uint8_t> expected;
    for (auto& frame : frames) {
        uint8_t hash[32];
        int quality = 0;
        hvd_pdq_hash_frame(frame.data(), W, H, hash, &quality);
        if (quality >= 31) expected.insert(expected.end(), hash, hash + 32);
    }

    for (int round = 0; round < 3; round++) {
        void* hasher = hvd_hasher_create(W, H, 8, 31);
        for (auto& frame : frames) hvd_hasher_push(hasher, frame.data());
        long n = hvd_hasher_finish(hasher);
        std::vector<uint8_t> got(n);
        if (n) hvd_hasher_copy(hasher, got.data());
        hvd_hasher_destroy(hasher);
        if ((size_t)n != expected.size() ||
            std::memcmp(got.data(), expected.data(), n) != 0) {
            std::fprintf(stderr, "round %d: threaded result mismatch\n", round);
            return 1;
        }
    }
    std::printf("tsan stress ok (%d frames x 3 rounds, 8 workers)\n", FRAMES);
    return 0;
}

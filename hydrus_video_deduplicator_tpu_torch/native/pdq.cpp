// PDQ/VPDQ native implementation: per-frame perceptual hashing, a threaded
// streaming video hasher with bounded-queue backpressure, and VPDQ
// similarity over packed hash blobs.
//
// This is the CPU compute path of the framework (the reference keeps its hot
// compute in a compiled extension, hvdaccelerators — SURVEY.md §2 row N1) and
// the bit-exactness oracle for the TPU kernels. The arithmetic follows the
// "exact-by-construction PDQ" spec in vpdq/pdq_math.py: fixed-order f32 add
// chains, reciprocal multiplies instead of divides, no FMA contraction
// (build with -ffp-contract=off), truncation-to-int matching C casts.
//
// Reference behavior contract (paths in the upstream hydrus-video-deduplicator repository):
//   - VideoHasher(average_fps, width, height, num_threads) with blocking
//     hash_frame + finish: src/hydrusvideodeduplicator/vpdqpy/vpdqpy.py:113-119
//   - quality >= 31 frames kept: src/hydrusvideodeduplicator/db/DedupeDB.py:550-553
//   - matchHash/matchHashBytes similarity in [0,100], tolerance 31:
//     vpdqpy/vpdqpy.py:49-56, db/vptree.py:28-31

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include "pdq_tables.h"

namespace {

inline float f32_from_bits(uint32_t b) {
    float f;
    std::memcpy(&f, &b, sizeof(f));
    return f;
}

struct Tables {
    float dct[PDQ_DCT_DIM][PDQ_BUF_DIM];
    float recip[PDQ_WINDOW + 1];
    float quality_scale;
    Tables() {
        for (int i = 0; i < PDQ_DCT_DIM; i++)
            for (int j = 0; j < PDQ_BUF_DIM; j++)
                dct[i][j] = f32_from_bits(PDQ_DCT_MATRIX_BITS[i * PDQ_BUF_DIM + j]);
        for (int c = 0; c <= PDQ_WINDOW; c++) recip[c] = f32_from_bits(PDQ_RECIP_BITS[c]);
        quality_scale = f32_from_bits(PDQ_QUALITY_SCALE_BITS);
    }
};

const Tables& tables() {
    static Tables t;
    return t;
}

// One box pass along a row or column of a w x h buffer. Window extents and
// reciprocals are general (any count); for the 512-path counts are 2..4 and
// the reciprocals match the shared table bit-for-bit because both sides
// compute (float)(1.0 / (double)count).
inline float recip_for(int count) {
    if (count <= PDQ_WINDOW) return tables().recip[count];
    return (float)(1.0 / (double)count);
}

// Box-filter `n` elements with stride `stride`, window [i-off_l, i+off_r].
//
// Window-4 passes use the spec's pairwise-tree order (pdq_math.py): left
// pair a2 = x[i-1] + x[i], right pair b2 = x[i+1] + x[i+2] (out-of-frame
// terms exact 0.0f), s4 = a2 + b2, then the reciprocal multiply. This is
// the order the TPU kernels reproduce. Other windows (only reachable for
// non-512 inputs, a C++-only convenience) fall back to a sequential
// clipped chain.
void box_pass_1d(const float* in, float* out, float* scratch, int n, int stride, int off_l,
                 int off_r) {
    int window = off_l + off_r + 1;
    if (window == 4 && off_l == 1 && off_r == 2) {
        float* a = scratch;      // a2[i] = x[i-1] + x[i], left-clipped
        float* b = scratch + n;  // b2[i] = x[i+1] + x[i+2], right-clipped
        for (int i = 0; i < n; i++) {
            float xm1 = (i - 1 >= 0) ? in[(size_t)(i - 1) * stride] : 0.0f;
            a[i] = xm1 + in[(size_t)i * stride];
            float xp1 = (i + 1 < n) ? in[(size_t)(i + 1) * stride] : 0.0f;
            float xp2 = (i + 2 < n) ? in[(size_t)(i + 2) * stride] : 0.0f;
            b[i] = xp1 + xp2;
        }
        for (int i = 0; i < n; i++) {
            float s4 = a[i] + b[i];
            int lo = i - off_l;
            if (lo < 0) lo = 0;
            int hi = i + off_r;
            if (hi > n - 1) hi = n - 1;
            out[(size_t)i * stride] = s4 * recip_for(hi - lo + 1);
        }
        return;
    }
    for (int i = 0; i < n; i++) {
        int lo = i - off_l;
        if (lo < 0) lo = 0;
        int hi = i + off_r;
        if (hi > n - 1) hi = n - 1;
        float acc = 0.0f;
        for (int k = lo; k <= hi; k++) acc = acc + in[(size_t)k * stride];
        out[(size_t)i * stride] = acc * recip_for(hi - lo + 1);
    }
}

struct Dims {
    int window, off_l, off_r;
    explicit Dims(int n) {
        // upstream PDQ computeJaroszFilterWindowSize: ceil(n / (2 * 64))
        window = (n + 2 * PDQ_BUF_DIM - 1) / (2 * PDQ_BUF_DIM);
        off_r = (window + 2) / 2 - 1;
        off_l = window - 1 - off_r;
    }
};

// Full PDQ of one interleaved rgb24 frame of size w x h.
void pdq_hash_frame_impl(const uint8_t* rgb, int w, int h, uint8_t out_hash[PDQ_BYTES_PER_HASH],
                         int* out_quality, float* dbg_buf64, float* dbg_dct) {
    const Tables& T = tables();
    std::vector<float> buf_a((size_t)w * h), buf_b((size_t)w * h);

    // 1. luma (Rec.601 x1000, integer-exact then converted to f32)
    for (int i = 0; i < w * h; i++) {
        int32_t milli = PDQ_LUMA_R * (int32_t)rgb[3 * i] + PDQ_LUMA_G * (int32_t)rgb[3 * i + 1] +
                        PDQ_LUMA_B * (int32_t)rgb[3 * i + 2];
        buf_a[i] = (float)milli;
    }

    // 2. Jarosz filter: rep 1 = (rows, cols), rep 2 = (cols, rows). The
    //    rep-2 axis swap is a pure f32 rounding reorder (box passes along
    //    different axes commute exactly) that lets the TPU kernel restrict
    //    rep 2 to the decimation sites — see pdq_math.py's pass-order note.
    Dims dw(w), dh(h);
    std::vector<float> scratch(2 * (size_t)(w > h ? w : h));
    for (int r = 0; r < h; r++)  // rep 1: along each row (contiguous)
        box_pass_1d(&buf_a[(size_t)r * w], &buf_b[(size_t)r * w], scratch.data(), w, 1,
                    dw.off_l, dw.off_r);
    for (int c = 0; c < w; c++)  // rep 1: along each column (stride w)
        box_pass_1d(&buf_b[c], &buf_a[c], scratch.data(), h, w, dh.off_l, dh.off_r);
    for (int c = 0; c < w; c++)  // rep 2: columns first
        box_pass_1d(&buf_a[c], &buf_b[c], scratch.data(), h, w, dh.off_l, dh.off_r);
    for (int r = 0; r < h; r++)  // rep 2: rows second
        box_pass_1d(&buf_b[(size_t)r * w], &buf_a[(size_t)r * w], scratch.data(), w, 1,
                    dw.off_l, dw.off_r);

    // 3. decimate at ((2i+1)*h)/(2*64), ((2j+1)*w)/(2*64)
    float buf64[PDQ_BUF_DIM][PDQ_BUF_DIM];
    for (int i = 0; i < PDQ_BUF_DIM; i++) {
        int ini = ((2 * i + 1) * h) / (2 * PDQ_BUF_DIM);
        for (int j = 0; j < PDQ_BUF_DIM; j++) {
            int inj = ((2 * j + 1) * w) / (2 * PDQ_BUF_DIM);
            buf64[i][j] = buf_a[(size_t)ini * w + inj];
        }
    }
    if (dbg_buf64) std::memcpy(dbg_buf64, buf64, sizeof(buf64));

    // 4. quality: trunc((u - v) * QUALITY_SCALE), summed |.| over vertical
    //    then horizontal neighbor pairs.
    int64_t gradient_sum = 0;
    for (int i = 0; i < PDQ_BUF_DIM - 1; i++)
        for (int j = 0; j < PDQ_BUF_DIM; j++) {
            int d = (int)((buf64[i][j] - buf64[i + 1][j]) * T.quality_scale);
            gradient_sum += d < 0 ? -d : d;
        }
    for (int i = 0; i < PDQ_BUF_DIM; i++)
        for (int j = 0; j < PDQ_BUF_DIM - 1; j++) {
            int d = (int)((buf64[i][j] - buf64[i][j + 1]) * T.quality_scale);
            gradient_sum += d < 0 ? -d : d;
        }
    int quality = (int)(gradient_sum / PDQ_QUALITY_DENOM);
    if (quality > PDQ_QUALITY_MAX) quality = PDQ_QUALITY_MAX;
    *out_quality = quality;

    // 5. DCT: out16 = D @ buf64 @ D^T, fixed-order k chains (no FMA:
    //    -ffp-contract=off). Bit-identical to the numpy oracle and the
    //    TPU path; the CPU-XLA fallback may drift ~1 ulp (LLVM FMA).
    float tmp[PDQ_DCT_DIM][PDQ_BUF_DIM];
    for (int i = 0; i < PDQ_DCT_DIM; i++)
        for (int j = 0; j < PDQ_BUF_DIM; j++) tmp[i][j] = 0.0f;
    for (int k = 0; k < PDQ_BUF_DIM; k++)
        for (int i = 0; i < PDQ_DCT_DIM; i++)
            for (int j = 0; j < PDQ_BUF_DIM; j++) {
                float prod = T.dct[i][k] * buf64[k][j];
                tmp[i][j] = tmp[i][j] + prod;
            }
    float dct16[PDQ_DCT_DIM][PDQ_DCT_DIM];
    for (int i = 0; i < PDQ_DCT_DIM; i++)
        for (int j = 0; j < PDQ_DCT_DIM; j++) dct16[i][j] = 0.0f;
    for (int k = 0; k < PDQ_BUF_DIM; k++)
        for (int i = 0; i < PDQ_DCT_DIM; i++)
            for (int j = 0; j < PDQ_DCT_DIM; j++) {
                float prod = tmp[i][k] * T.dct[j][k];
                dct16[i][j] = dct16[i][j] + prod;
            }
    if (dbg_dct) std::memcpy(dbg_dct, dct16, sizeof(dct16));

    // 6. median threshold: 128th-smallest of 256 (== torben for n=256)
    float sorted[PDQ_DCT_DIM * PDQ_DCT_DIM];
    std::memcpy(sorted, dct16, sizeof(sorted));
    std::nth_element(sorted, sorted + 127, sorted + 256);
    float median = sorted[127];

    // 7. pack: bit b=i*16+j -> word w[i] bit j; blob = w15..w0 big-endian.
    uint16_t words[PDQ_DCT_DIM];
    for (int i = 0; i < PDQ_DCT_DIM; i++) {
        uint16_t wrd = 0;
        for (int j = 0; j < PDQ_DCT_DIM; j++)
            if (dct16[i][j] > median) wrd |= (uint16_t)(1u << j);
        words[i] = wrd;
    }
    for (int i = 0; i < PDQ_DCT_DIM; i++) {
        out_hash[2 * (PDQ_DCT_DIM - 1 - i)] = (uint8_t)(words[i] >> 8);
        out_hash[2 * (PDQ_DCT_DIM - 1 - i) + 1] = (uint8_t)(words[i] & 0xff);
    }
}

// ---------------------------------------------------------------------------
// Similarity
// ---------------------------------------------------------------------------

inline int hamming256(const uint8_t* a, const uint8_t* b) {
    uint64_t xa, xb;
    int d = 0;
    for (int k = 0; k < 4; k++) {
        std::memcpy(&xa, a + 8 * k, 8);
        std::memcpy(&xb, b + 8 * k, 8);
        d += __builtin_popcountll(xa ^ xb);
    }
    return d;
}

// similarity = 100 * min(matched_a/len_a, matched_b/len_b); match when the
// min Hamming distance to any frame of the other video is <= tolerance.
// Either side empty -> 0.0.
double match_hash_bytes_impl(const uint8_t* a, long alen, const uint8_t* b, long blen, int tol) {
    long na = alen / PDQ_BYTES_PER_HASH, nb = blen / PDQ_BYTES_PER_HASH;
    if (na == 0 || nb == 0) return 0.0;
    std::vector<uint8_t> matched_b(nb, 0);
    long ma = 0;
    for (long i = 0; i < na; i++) {
        bool any = false;
        const uint8_t* fa = a + i * PDQ_BYTES_PER_HASH;
        for (long j = 0; j < nb; j++) {
            if (hamming256(fa, b + j * PDQ_BYTES_PER_HASH) <= tol) {
                any = true;
                matched_b[j] = 1;
            }
        }
        if (any) ma++;
    }
    long mb = 0;
    for (long j = 0; j < nb; j++) mb += matched_b[j];
    double pa = 100.0 * (double)ma / (double)na;
    double pb = 100.0 * (double)mb / (double)nb;
    return pa < pb ? pa : pb;
}

// ---------------------------------------------------------------------------
// Threaded streaming VideoHasher
// ---------------------------------------------------------------------------

struct FrameResult {
    uint8_t hash[PDQ_BYTES_PER_HASH];
    int quality = -1;
};

class VideoHasher {
  public:
    VideoHasher(int w, int h, int num_threads, int quality_min)
        : w_(w), h_(h), quality_min_(quality_min) {
        unsigned hw = std::thread::hardware_concurrency();
        if (hw == 0) hw = 1;
        int n;
        if (num_threads > 0) {
            n = num_threads;
        } else if (num_threads == 0) {
            n = (int)hw - 1;  // default: all cores but one
        } else {
            n = (int)hw + 1 + num_threads;  // -1 = all cores, -2 = all but one, ...
        }
        if (n < 1) n = 1;
        capacity_ = (size_t)(2 * n + 2);
        for (int i = 0; i < n; i++) workers_.emplace_back([this] { worker(); });
    }

    ~VideoHasher() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            done_ = true;
        }
        cv_pop_.notify_all();
        for (auto& t : workers_)
            if (t.joinable()) t.join();
    }

    // Blocks while the queue is full (decode -> hash backpressure,
    // reference vpdqpy.py:114-118).
    void push(const uint8_t* rgb) {
        std::unique_lock<std::mutex> lk(mu_);
        cv_push_.wait(lk, [this] { return queue_.size() < capacity_; });
        queue_.emplace_back(next_index_++, std::vector<uint8_t>(rgb, rgb + (size_t)w_ * h_ * 3));
        results_.resize(next_index_);
        lk.unlock();
        cv_pop_.notify_one();
    }

    // Drain, join, and pack kept frames (quality >= quality_min) in order.
    // Returns the packed byte length; bytes are fetched with copy_finished().
    long finish() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            done_ = true;
        }
        cv_pop_.notify_all();
        for (auto& t : workers_)
            if (t.joinable()) t.join();
        finished_.clear();
        finished_.reserve(results_.size() * PDQ_BYTES_PER_HASH);
        for (const auto& r : results_)
            if (r.quality >= quality_min_)
                finished_.insert(finished_.end(), r.hash, r.hash + PDQ_BYTES_PER_HASH);
        return (long)finished_.size();
    }

    void copy_finished(uint8_t* out) const {
        std::memcpy(out, finished_.data(), finished_.size());
    }

  private:
    void worker() {
        for (;;) {
            std::pair<size_t, std::vector<uint8_t>> job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_pop_.wait(lk, [this] { return !queue_.empty() || done_; });
                if (queue_.empty()) return;
                job = std::move(queue_.front());
                queue_.pop_front();
            }
            cv_push_.notify_one();
            FrameResult r;
            pdq_hash_frame_impl(job.second.data(), w_, h_, r.hash, &r.quality, nullptr, nullptr);
            {
                std::unique_lock<std::mutex> lk(mu_);
                results_[job.first] = r;
            }
        }
    }

    int w_, h_, quality_min_;
    std::vector<uint8_t> finished_;
    size_t capacity_;
    size_t next_index_ = 0;
    bool done_ = false;
    std::mutex mu_;
    std::condition_variable cv_push_, cv_pop_;
    std::deque<std::pair<size_t, std::vector<uint8_t>>> queue_;
    std::vector<FrameResult> results_;
    std::vector<std::thread> workers_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

int hvd_abi_version() { return 1; }

void hvd_pdq_hash_frame(const uint8_t* rgb, int w, int h, uint8_t* out_hash, int* out_quality) {
    pdq_hash_frame_impl(rgb, w, h, out_hash, out_quality, nullptr, nullptr);
}

// Debug hook: also exports the decimated 64x64 buffer and the 16x16 DCT.
void hvd_pdq_hash_frame_debug(const uint8_t* rgb, int w, int h, uint8_t* out_hash,
                              int* out_quality, float* out_buf64, float* out_dct) {
    pdq_hash_frame_impl(rgb, w, h, out_hash, out_quality, out_buf64, out_dct);
}

// Batched single-threaded hashing (oracle for the TPU batch kernel).
void hvd_pdq_hash_frames(const uint8_t* rgb, long n, int w, int h, uint8_t* out_hashes,
                         int* out_qualities) {
    for (long i = 0; i < n; i++)
        pdq_hash_frame_impl(rgb + i * (size_t)w * h * 3, w, h,
                            out_hashes + i * PDQ_BYTES_PER_HASH, out_qualities + i, nullptr,
                            nullptr);
}

double hvd_match_hash_bytes(const uint8_t* a, long alen, const uint8_t* b, long blen, int tol) {
    return match_hash_bytes_impl(a, alen, b, blen, tol);
}

// Greedy leader clustering of one video's frame hashes (the exact-prune
// representative extraction, ops/reps.py): frames scan the leaders in
// creation order and join the FIRST leader within radius_cap; otherwise
// they become a new leader. Invariant (the exactness contract of the
// pruned search route): every frame is within radius_cap Hamming of the
// leader frame of its cluster. out_leaders receives the frame indices of
// the leaders in creation order; returns the leader count k (<= n).
long hvd_cluster_reps(const uint8_t* blob, long n, int radius_cap, int32_t* out_leaders) {
    long k = 0;
    for (long i = 0; i < n; i++) {
        const uint8_t* f = blob + i * PDQ_BYTES_PER_HASH;
        bool covered = false;
        for (long c = 0; c < k; c++) {
            const uint8_t* leader = blob + (size_t)out_leaders[c] * PDQ_BYTES_PER_HASH;
            if (hamming256(f, leader) <= radius_cap) {
                covered = true;
                break;
            }
        }
        if (!covered) out_leaders[k++] = (int32_t)i;
    }
    return k;
}

// Batched hvd_cluster_reps over a whole corpus: blob holds every video's
// frames concatenated; offsets[v]..offsets[v+1] (in frames) delimit video
// v. out_leaders receives GLOBAL frame indices, videos back to back;
// out_counts[v] = leader count of video v. One call per corpus keeps the
// ctypes boundary off the per-video path (1M videos = 1 call).
//
// Threaded: per-video clustering is independent, so phase 1 fans videos
// over a pool (each video writes LOCAL leader indices into its own
// frame-offset region of out_leaders — the caller sizes it at one slot
// per frame) and a serial phase 2 compacts the regions into the packed
// layout and globalizes the indices (write cursor w <= read cursor f0
// always, so in-place is safe). Results are bit-identical for any
// thread count. HVD_CLUSTER_THREADS overrides the pool size.
void hvd_cluster_reps_batch(const uint8_t* blob, const int64_t* offsets, long n_videos,
                            int radius_cap, int32_t* out_leaders, int32_t* out_counts) {
    long nthreads = (long)std::thread::hardware_concurrency();
    if (const char* e = std::getenv("HVD_CLUSTER_THREADS")) nthreads = std::atol(e);
    if (nthreads < 1) nthreads = 1;
    if (nthreads > n_videos) nthreads = n_videos ? n_videos : 1;

    std::atomic<long> next{0};
    const long GRAIN = 256;
    auto worker = [&]() {
        for (;;) {
            long v0 = next.fetch_add(GRAIN);
            if (v0 >= n_videos) return;
            long v1 = std::min(n_videos, v0 + GRAIN);
            for (long v = v0; v < v1; v++) {
                long f0 = offsets[v], f1 = offsets[v + 1];
                out_counts[v] = (int32_t)hvd_cluster_reps(
                    blob + f0 * PDQ_BYTES_PER_HASH, f1 - f0, radius_cap,
                    out_leaders + f0);
            }
        }
    };
    if (nthreads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve((size_t)nthreads);
        for (long t = 0; t < nthreads; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }

    long w = 0;
    for (long v = 0; v < n_videos; v++) {
        long f0 = offsets[v];
        long k = out_counts[v];
        for (long c = 0; c < k; c++)
            out_leaders[w + c] = out_leaders[f0 + c] + (int32_t)f0;
        w += k;
    }
}

// All-pairs frame Hamming distances: [na,32] x [nb,32] -> int32 [na*nb].
void hvd_hamming_matrix(const uint8_t* a, long na, const uint8_t* b, long nb, int32_t* out) {
    for (long i = 0; i < na; i++)
        for (long j = 0; j < nb; j++)
            out[i * nb + j] = hamming256(a + i * PDQ_BYTES_PER_HASH, b + j * PDQ_BYTES_PER_HASH);
}

void* hvd_hasher_create(int w, int h, int num_threads, int quality_min) {
    return new VideoHasher(w, h, num_threads, quality_min);
}

void hvd_hasher_push(void* hasher, const uint8_t* rgb) {
    static_cast<VideoHasher*>(hasher)->push(rgb);
}

// Returns the packed byte length; result is stashed in the hasher until
// hvd_hasher_copy is called.
long hvd_hasher_finish(void* hasher) { return static_cast<VideoHasher*>(hasher)->finish(); }

void hvd_hasher_copy(void* hasher, uint8_t* out) {
    static_cast<VideoHasher*>(hasher)->copy_finished(out);
}

void hvd_hasher_destroy(void* hasher) { delete static_cast<VideoHasher*>(hasher); }

}  // extern "C"

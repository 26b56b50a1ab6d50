// Native round-robin weighted plate flood fill — the sequential host hot
// loop of coarse-grid tectonics (re-design of reference js/plates.js:117-214;
// same algorithm as the Python fallback in tectonics/plates.py, bit-identical
// results including Park-Miller stream consumption).
//
// This is the one genuinely sequential piece of the pipeline (RNG draws
// inside a data-dependent frontier loop), so it lives in C++ on the host
// while everything per-cell runs on the TPU. Exposed via a C ABI for ctypes.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t PM_M = 2147483647;
constexpr int64_t PM_A = 16807;

struct PmStream {
    int64_t s;
    double next() {
        s = (s * PM_A) % PM_M;
        return static_cast<double>(s - 1) / 2147483646.0;
    }
};

}  // namespace

extern "C" {

// Returns 0 on success. r_plate must be initialized to -1 with seeds set to
// their slot ids. rng_state/randint_state are Park-Miller states (updated).
int coarse_fill_plates(
    int32_t n, int32_t p, int32_t k_max, int32_t num_plates_param,
    const int32_t* nbr_idx,     // [n, k_max]
    const uint8_t* nbr_mask,    // [n, k_max]
    const double* pos,          // [n, 3]
    const int32_t* seeds,       // [p]
    const double* growth_rate,  // [p]
    const double* growth_dir,   // [p, 3]
    const double* dir_strength, // [p]
    double expected_area, double governor_mult, double compact_weight,
    int64_t* rng_state, int64_t* randint_state,
    int32_t* r_plate)           // [n] inout
{
    PmStream rng{*rng_state};
    PmStream randint{*randint_state};

    std::vector<std::vector<int32_t>> frontier(p);
    std::vector<int64_t> area(p, 1);
    for (int i = 0; i < p; i++) frontier[i].push_back(seeds[i]);

    const double inv_n = 1.0 / n;
    int64_t remaining = n - p;

    while (remaining > 0) {
        bool any_progress = false;
        for (int pid = 0; pid < p; pid++) {
            auto& fr = frontier[pid];
            if (fr.empty()) continue;
            const double rate = growth_rate[pid];
            const double d0 = growth_dir[3 * pid];
            const double d1 = growth_dir[3 * pid + 1];
            const double d2 = growth_dir[3 * pid + 2];
            const double dstr = dir_strength[pid];
            int64_t steps = static_cast<int64_t>(
                std::ceil(rate * (0.5 + rng.next())));
            if (steps < 1) steps = 1;
            if (area[pid] > expected_area * governor_mult) {
                steps = static_cast<int64_t>(std::ceil(steps * 0.5));
                if (steps < 1) steps = 1;
            }
            const double expected_chord =
                std::sqrt(area[pid] * inv_n / M_PI) * 2.0;
            const double compact_threshold = expected_chord * 1.8;
            const int32_t seed_cell = seeds[pid];
            const double sx = pos[3 * seed_cell];
            const double sy = pos[3 * seed_cell + 1];
            const double sz = pos[3 * seed_cell + 2];

            for (int64_t s = 0; s < steps && !fr.empty(); s++) {
                const int64_t fl = static_cast<int64_t>(fr.size());
                int64_t samples = 3 + static_cast<int64_t>(dstr * 5);
                if (samples > fl) samples = fl;

                // draw all idx values first, then all rng values — matches
                // the Python implementation's per-stream buffered order
                int64_t idxs[8];
                double rnds[8];
                for (int64_t i = 0; i < samples; i++)
                    idxs[i] = static_cast<int64_t>(randint.next() * fl);
                for (int64_t i = 0; i < samples; i++)
                    rnds[i] = rng.next();

                double best_score = -1e300;
                int64_t best_idx = 0;
                for (int64_t i = 0; i < samples; i++) {
                    const int32_t cell = fr[idxs[i]];
                    const double dx = pos[3 * cell] - sx;
                    const double dy = pos[3 * cell + 1] - sy;
                    const double dz = pos[3 * cell + 2] - sz;
                    const double dlen_sq = dx * dx + dy * dy + dz * dz;
                    double dlen = std::sqrt(dlen_sq);
                    if (dlen == 0.0) dlen = 1.0;
                    const double alignment = (dx * d0 + dy * d1 + dz * d2) / dlen;
                    double excess = dlen_sq * 0.5 - compact_threshold;
                    if (excess < 0) excess = 0;
                    const double penalty = excess * (compact_weight * 4.0);
                    const double score =
                        alignment * dstr + rnds[i] * (1.0 - dstr * 0.5) - penalty;
                    if (score > best_score) {
                        best_score = score;
                        best_idx = idxs[i];
                    }
                }

                const int32_t cell = fr[best_idx];
                fr[best_idx] = fr.back();
                fr.pop_back();

                const int32_t* row = nbr_idx + static_cast<int64_t>(cell) * k_max;
                const uint8_t* msk = nbr_mask + static_cast<int64_t>(cell) * k_max;
                for (int j = 0; j < k_max; j++) {
                    if (!msk[j]) continue;
                    const int32_t nb = row[j];
                    if (r_plate[nb] == -1) {
                        r_plate[nb] = pid;
                        fr.push_back(nb);
                        area[pid]++;
                        remaining--;
                        any_progress = true;
                    }
                }
            }
        }
        if (!any_progress) break;
    }

    // orphan adoption (js/plates.js:199-214): first assigned neighbor in
    // adjacency order, repeated until no orphan can be adopted
    bool orphans = true;
    while (orphans) {
        orphans = false;
        for (int32_t r = 0; r < n; r++) {
            if (r_plate[r] != -1) continue;
            const int32_t* row = nbr_idx + static_cast<int64_t>(r) * k_max;
            const uint8_t* msk = nbr_mask + static_cast<int64_t>(r) * k_max;
            for (int j = 0; j < k_max; j++) {
                if (msk[j] && r_plate[row[j]] != -1) {
                    r_plate[r] = r_plate[row[j]];
                    orphans = true;
                    break;
                }
            }
        }
    }

    *rng_state = rng.s;
    *randint_state = randint.s;
    return 0;
}

}  // extern "C"

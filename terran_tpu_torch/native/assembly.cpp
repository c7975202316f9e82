// Native host code for the OpenPose assembly tail: greedy limb matching
// and incremental human merging.
//
// The port of terran_tpu/native/assembly.cpp, with the part count and the
// limbs that may start a human as arguments, so that one build assembles
// both the COCO model's 18 parts and BODY_25's 25. The stages are sequential,
// data-dependent host work (the reference openpose/wrapper.py:335-478);
// the Python version in terran_tpu_torch/pose/assembly.py is kept as the
// reference and the fallback, and the two are tested equal.
//
// Built at first use by terran_tpu_torch/native/__init__.py (g++ -O2
// -shared) and bound with ctypes: a plain C interface, no Python headers.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Greedy highest-score matching for one limb.
//
// reg:    (k x k) row-major scores.
// accept: (k x k) row-major acceptance flags.
// count_src/count_dst: valid slot counts (loop stops at the min, matching
//   the Python/reference semantics).
// out:    ((k) x 3) buffer receiving (src_slot, dst_slot, score) rows.
// Returns the number of connections written.
int greedy_connections(const float* reg, const uint8_t* accept, int k,
                       int count_src, int count_dst, double* out) {
    struct Cand { int i, j; float score; int order; };
    std::vector<Cand> cands;
    cands.reserve(64);
    for (int i = 0; i < k; ++i) {
        for (int j = 0; j < k; ++j) {
            if (accept[i * k + j]) {
                cands.push_back({i, j, reg[i * k + j],
                                 static_cast<int>(cands.size())});
            }
        }
    }
    // Descending score; stable on the row-major candidate order like
    // numpy argsort on equal keys encountered in practice.
    std::stable_sort(cands.begin(), cands.end(),
                     [](const Cand& a, const Cand& b) {
                         return a.score > b.score;
                     });

    // The reference keeps ONE `seen` set shared by src and dst slot indices
    // (wrapper.py:336,356-359) — a used dst index also blocks the
    // same-numbered src index. Quirk preserved for parity.
    std::vector<uint8_t> seen(k, 0);
    int n = 0;
    int limit = std::min(count_src, count_dst);
    for (const Cand& c : cands) {
        if (!seen[c.i] && !seen[c.j]) {
            out[n * 3 + 0] = c.i;
            out[n * 3 + 1] = c.j;
            out[n * 3 + 2] = c.score;
            ++n;
            if (n >= limit) break;
            seen[c.i] = 1;
            seen[c.j] = 1;
        }
    }
    return n;
}

// Incremental human assembly over all limbs.
//
// Inputs are the fixed-size device outputs for ONE image:
//   peak_scores: (num_parts x k)          heatmap scores per slot
//   counts:      (num_parts)              valid slots per part
//   offsets:     (num_parts)              global peak-id base per part
//   reg:         (num_limbs x k x k)      limb scores
//   accept:      (num_limbs x k x k)      acceptance flags
//   limbseq:     (num_limbs x 2)          0-based part ids per limb
//   starts:      (num_limbs)              whether a limb matching no human
//                                         may start one (COCO-18: all but
//                                         the last two; BODY_25: all but
//                                         18 and 19)
// Output:
//   humans_out:  (max_humans x (num_parts + 2)) row-major; first num_parts
//                entries are global peak ids (or -1), then score sum, then
//                keypoint count — the reference layout (wrapper.py:368-380).
// Returns the number of surviving humans.
int assemble_humans(const float* peak_scores, const int* counts,
                    const int* offsets, const float* reg,
                    const uint8_t* accept, const int* limbseq,
                    const uint8_t* starts, int num_parts, int num_limbs,
                    int k, double human_threshold, int max_humans,
                    double* humans_out) {
    const int HUMAN_LEN = num_parts + 2;
    const int SCORE = num_parts, COUNT = num_parts + 1;
    std::vector<std::vector<double>> humans;
    std::vector<double> conns(static_cast<size_t>(k) * 3);

    for (int limb = 0; limb < num_limbs; ++limb) {
        int kpid_src = limbseq[limb * 2 + 0];
        int kpid_dst = limbseq[limb * 2 + 1];
        if (counts[kpid_src] == 0 || counts[kpid_dst] == 0) continue;

        int n = greedy_connections(reg + static_cast<size_t>(limb) * k * k,
                                   accept + static_cast<size_t>(limb) * k * k,
                                   k, counts[kpid_src], counts[kpid_dst],
                                   conns.data());

        for (int c = 0; c < n; ++c) {
            int src_slot = static_cast<int>(conns[c * 3 + 0]);
            int dst_slot = static_cast<int>(conns[c * 3 + 1]);
            double score = conns[c * 3 + 2];
            double peak_src = offsets[kpid_src] + src_slot;
            double peak_dst = offsets[kpid_dst] + dst_slot;
            double src_score = peak_scores[kpid_src * k + src_slot];
            double dst_score = peak_scores[kpid_dst * k + dst_slot];

            // Count ALL matching humans: the Python/reference if/elif
            // structure handles exactly 1 or exactly 2 matches and silently
            // skips the connection otherwise (3+ is reachable after an
            // overlap-conflict tiebreak leaves two humans sharing a peak),
            // so breaking out at the second match would diverge.
            int match1 = -1, match2 = -1, match_count = 0;
            for (size_t h = 0; h < humans.size(); ++h) {
                if (humans[h][kpid_src] == peak_src ||
                    humans[h][kpid_dst] == peak_dst) {
                    if (match1 < 0) match1 = static_cast<int>(h);
                    else if (match2 < 0) match2 = static_cast<int>(h);
                    ++match_count;
                }
            }

            if (match_count > 2) continue;

            if (match1 >= 0 && match2 < 0) {
                std::vector<double>& human = humans[match1];
                if (human[kpid_dst] != peak_dst) {
                    human[kpid_dst] = peak_dst;
                    human[COUNT] += 1;
                    human[SCORE] += dst_score + score;
                }
            } else if (match2 >= 0) {
                std::vector<double>& h1 = humans[match1];
                std::vector<double>& h2 = humans[match2];
                bool overlapping = false;
                for (int p = 0; p < num_parts; ++p) {
                    if (h1[p] >= 0 && h2[p] >= 0) { overlapping = true; break; }
                }
                if (!overlapping) {
                    // Merge disjoint part sets (+1 compensates the -1
                    // absence marker, reference wrapper.py:432-442).
                    for (int p = 0; p < num_parts; ++p) h1[p] += h2[p] + 1;
                    h1[SCORE] += h2[SCORE] + score;
                    h1[COUNT] += h2[COUNT];
                    humans.erase(humans.begin() + match2);
                } else {
                    h1[kpid_dst] = peak_dst;
                    h1[COUNT] += 1;
                    h1[SCORE] += dst_score + score;
                }
            } else if (match1 < 0 && starts[limb]) {
                std::vector<double> human(HUMAN_LEN, -1.0);
                human[kpid_src] = peak_src;
                human[kpid_dst] = peak_dst;
                human[COUNT] = 2;
                human[SCORE] = src_score + dst_score + score;
                humans.push_back(std::move(human));
            }
        }
    }

    int written = 0;
    for (const auto& human : humans) {
        if (human[COUNT] >= 4 &&
            human[SCORE] / human[COUNT] >= human_threshold) {
            if (written >= max_humans) break;
            std::memcpy(humans_out + static_cast<size_t>(written) * HUMAN_LEN,
                        human.data(), HUMAN_LEN * sizeof(double));
            ++written;
        }
    }
    return written;
}

}  // extern "C"

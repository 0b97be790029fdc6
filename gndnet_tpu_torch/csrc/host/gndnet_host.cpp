// gndnet_host: native host-side runtime kernels.
//
// The reference's "native layer" is numba-JIT'd Python (reference:
// utils/point_cloud_ops.py:7-104, utils/utils.py:198-295, plus an AOT stub
// utils/transform.py:8-11); this library is its C++ equivalent for the host
// side of the serving stack:
//
//   * voxelize(): the reference's exact sequential first-touch voxelizer,
//     including the break-on-capacity behavior (point_cloud_ops.py:43-45) —
//     used as the host-parity oracle;
//   * segment_cloud(): threshold segmentation with the reference's 0 < idx
//     bounds (utils/utils.py:198-220);
//   * shift_cloud(), transform_cloud(): trivial host transforms;
//   * mailbox_*: a lock-free latest-value mailbox (triple buffer, acquire/
//     release atomics) replacing the reference's mutex-guarded latest-input
//     hand-off between the sensor callback and the inference thread
//     (ros_node.py:58,104-138) — the memcpy runs outside the GIL.
//
// Built by gndnet_tpu_torch/native.py at first use (g++ -O3 -fPIC -std=c++17
// -shared) into gndnet_tpu_torch/_build/, and loaded there with ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// voxelizer (reference-exact sequential semantics)
// ---------------------------------------------------------------------------

// points: (n, f) float32 row-major, xyz in columns 0..2.
// coor_map: caller-provided int32 workspace of size grid_x*grid_y*grid_z,
//           must be filled with -1 (reused across calls for speed).
// voxels:  (max_voxels, max_points, f) float32 out, zero-initialised by caller.
// coors:   (max_voxels, 3) int32 out (zyx when reverse != 0).
// num_points: (max_voxels,) int32 out, zero-initialised.
// Returns the number of voxels created.
int voxelize(const float* points, int64_t n, int f,
             const float* voxel_size, const float* pc_range,
             int max_points, int max_voxels, int reverse,
             int32_t* coor_map, float* voxels, int32_t* coors,
             int32_t* num_points, int reference_break) {
    int grid[3];
    for (int j = 0; j < 3; ++j) {
        grid[j] = (int)(0.5f + (pc_range[3 + j] - pc_range[j]) / voxel_size[j]);
    }
    int voxel_num = 0;
    for (int64_t i = 0; i < n; ++i) {
        int c[3];
        bool failed = false;
        for (int j = 0; j < 3; ++j) {
            float v = (points[i * f + j] - pc_range[j]) / voxel_size[j];
            int cj = (int)v;
            if (v < 0) cj -= 1;  // floor for negatives
            if (cj < 0 || cj >= grid[j]) { failed = true; break; }
            c[j] = cj;
        }
        if (failed) continue;
        // flat index in (z, y, x) map order to mirror the reference's
        // reversed voxelmap_shape (point_cloud_ops.py:144-145)
        int64_t flat = ((int64_t)c[2] * grid[1] + c[1]) * grid[0] + c[0];
        int32_t idx = coor_map[flat];
        if (idx == -1) {
            if (voxel_num >= max_voxels) {
                if (reference_break) break;  // drops ALL remaining points
                continue;
            }
            idx = voxel_num++;
            coor_map[flat] = idx;
            if (reverse) {
                coors[idx * 3 + 0] = c[2];
                coors[idx * 3 + 1] = c[1];
                coors[idx * 3 + 2] = c[0];
            } else {
                coors[idx * 3 + 0] = c[0];
                coors[idx * 3 + 1] = c[1];
                coors[idx * 3 + 2] = c[2];
            }
        }
        int32_t k = num_points[idx];
        if (k < max_points) {
            std::memcpy(&voxels[((int64_t)idx * max_points + k) * f],
                        &points[i * f], sizeof(float) * f);
            num_points[idx] = k + 1;
        }
    }
    return voxel_num;
}

// ---------------------------------------------------------------------------
// threshold segmentation (reference utils/utils.py:198-220 semantics)
// ---------------------------------------------------------------------------

void segment_cloud(const float* points, int64_t n, int f,
                   const float* grid_range, float cell,
                   const float* elevation, int h, int w,
                   float threshold, float* out_labels) {
    for (int64_t i = 0; i < n; ++i) {
        float fx = (points[i * f + 0] - grid_range[0]) / cell;
        float fy = (points[i * f + 1] - grid_range[1]) / cell;
        int x = (int)fx; if (fx < 0) x -= 1;
        int y = (int)fy; if (fy < 0) y -= 1;
        if (x > 0 && x < h && y > 0 && y < w) {
            out_labels[i] =
                (points[i * f + 2] > elevation[(int64_t)x * w + y] + threshold)
                    ? 1.0f : 0.0f;
        } else {
            out_labels[i] = -1.0f;
        }
    }
}

void shift_cloud(float* points, int64_t n, int f, float dz) {
    for (int64_t i = 0; i < n; ++i) points[i * f + 2] += dz;
}

// Apply a 4x4 row-major transform to xyz columns in place.
void transform_cloud(float* points, int64_t n, int f, const double* m) {
    for (int64_t i = 0; i < n; ++i) {
        double x = points[i * f + 0], y = points[i * f + 1],
               z = points[i * f + 2];
        points[i * f + 0] = (float)(m[0] * x + m[1] * y + m[2] * z + m[3]);
        points[i * f + 1] = (float)(m[4] * x + m[5] * y + m[6] * z + m[7]);
        points[i * f + 2] = (float)(m[8] * x + m[9] * y + m[10] * z + m[11]);
    }
}

// ---------------------------------------------------------------------------
// lock-free latest-value mailbox (triple buffer)
// ---------------------------------------------------------------------------
//
// One writer, one reader.  The writer always has a free slot to fill and
// publishes it with a release-exchange; the reader grabs the latest published
// slot with an acquire-exchange.  Neither side ever blocks.

// Ownership invariant: the writer privately owns `write_slot`, the reader
// privately owns `read_slot`, and the atomic `middle` always holds the third
// slot.  Both sides progress only by exchanging their private slot with the
// middle, so no slot index is ever shared mutably; freshness is carried by
// per-slot monotonic sequence numbers.

struct Mailbox {
    int64_t capacity;           // bytes per slot
    std::vector<uint8_t> slots; // 3 * capacity
    int64_t sizes[3];
    std::atomic<int64_t> seqs[3];
    std::atomic<int> middle;    // slot currently parked between the threads
    int write_slot;             // writer-private
    int read_slot;              // reader-private
    int64_t last_read_seq;      // reader-private freshness watermark
};

void* mailbox_create(int64_t capacity) {
    Mailbox* m = new Mailbox();
    m->capacity = capacity;
    m->slots.resize(3 * capacity);
    for (int i = 0; i < 3; ++i) {
        m->sizes[i] = 0;
        m->seqs[i].store(-1, std::memory_order_relaxed);
    }
    m->middle.store(1, std::memory_order_relaxed);
    m->write_slot = 0;
    m->read_slot = 2;
    m->last_read_seq = -1;
    return m;
}

void mailbox_destroy(void* p) { delete (Mailbox*)p; }

// Returns 0 on success, -1 if nbytes exceeds capacity.
int mailbox_write(void* p, const uint8_t* data, int64_t nbytes, int64_t seq) {
    Mailbox* m = (Mailbox*)p;
    if (nbytes > m->capacity) return -1;
    int s = m->write_slot;
    std::memcpy(&m->slots[(int64_t)s * m->capacity], data, nbytes);
    m->sizes[s] = nbytes;
    m->seqs[s].store(seq, std::memory_order_relaxed);
    m->write_slot = m->middle.exchange(s, std::memory_order_acq_rel);
    return 0;
}

// Returns nbytes copied (0 if nothing newer than the last read), fills seq.
int64_t mailbox_read_latest(void* p, uint8_t* out, int64_t max_bytes,
                            int64_t* seq) {
    Mailbox* m = (Mailbox*)p;
    int s = m->middle.exchange(m->read_slot, std::memory_order_acq_rel);
    m->read_slot = s;
    int64_t got = m->seqs[s].load(std::memory_order_relaxed);
    if (got <= m->last_read_seq) { *seq = m->last_read_seq; return 0; }
    m->last_read_seq = got;
    int64_t nbytes = m->sizes[s] < max_bytes ? m->sizes[s] : max_bytes;
    std::memcpy(out, &m->slots[(int64_t)s * m->capacity], nbytes);
    *seq = got;
    return nbytes;
}

}  // extern "C"

// voxnative — native scene-build kernels for voxtracer.
//
// The reference's host runtime is native (Rust): its hot loop converts
// voxel lists into the GPU octree (src/context.rs:710-773).  This is the
// equivalent native path here: one pass from a voxel list to the dense
// int32 grid the trace kernels march, and the .vox XYZI decode.  Python
// falls back to the numpy implementation when the library isn't built;
// both must produce bit-identical results (tests/test_native.py).
//
// Build: make -C native   (produces libvoxnative.so; ctypes loads it)

#include <cstdint>

extern "C" {

// Fill a dense int32 value grid from a voxel list.
//   pos:   n x 3 int16 voxel coordinates
//   leaf:  n int32 packed leaf values (pre-quantized by the caller)
//   grid:  (dx*dy*dz) int32, zero-initialized by the caller
// Later duplicates win, matching repeated octree insertion.
void vox_fill_grid(const int16_t* pos, const int32_t* leaf, int64_t n,
                   int32_t ox, int32_t oy, int32_t oz,
                   int64_t dx, int64_t dy, int64_t dz, int32_t* grid) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)pos[3 * i + 0] - ox;
    int64_t y = (int64_t)pos[3 * i + 1] - oy;
    int64_t z = (int64_t)pos[3 * i + 2] - oz;
    if (x < 0 || y < 0 || z < 0 || x >= dx || y >= dy || z >= dz) continue;
    grid[(x * dy + y) * dz + z] = leaf[i];
  }
}

// Decode a MagicaVoxel XYZI payload (n * [x y z ci] bytes) into engine
// voxels: swizzled (x, z, y) int16 positions and palette indices.
void vox_decode_xyzi(const uint8_t* xyzi, int64_t n, int16_t* pos,
                     uint8_t* color_index) {
  for (int64_t i = 0; i < n; ++i) {
    pos[3 * i + 0] = xyzi[4 * i + 0];
    pos[3 * i + 1] = xyzi[4 * i + 2];  // vox is z-up: engine y <- vox z
    pos[3 * i + 2] = xyzi[4 * i + 1];
    color_index[i] = xyzi[4 * i + 3];
  }
}

}  // extern "C"

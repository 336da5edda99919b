"""voxtracer — an interactive voxel path tracer in JAX for NVIDIA GPUs.

A JAX/XLA/Pallas re-design of the capabilities of
nolanderc/gpu-voxel-raytracer (Rust + wgpu + GLSL compute shaders):
MagicaVoxel scenes, 1 spp/frame progressive path tracing with sun
next-event estimation, temporal reprojection and a cross-bilateral
denoiser, in one jitted frame function.

Layer map (reference -> here):
  GLSL voxels.comp     -> voxtracer.ops.trace_triton (GPU) / trace_xla
  GLSL temporal.comp   -> voxtracer.ops.temporal
  GLSL denoise.comp    -> voxtracer.ops.denoise
  src/vox.rs           -> voxtracer.io.vox
  octree builder       -> voxtracer.scene.octree (ABI parity) +
                          voxtracer.scene.grid (dense grid the trace
                          kernels march)
  src/camera.rs        -> voxtracer.engine.camera
  src/context.rs       -> voxtracer.engine.pipeline + voxtracer.app
  src/cpu.rs (dead)    -> voxtracer.oracle (revived as golden reference)
"""

__version__ = "0.1.0"

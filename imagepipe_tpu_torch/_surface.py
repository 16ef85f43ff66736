"""What of the JAX package's public surface the port leaves out, and why.

`NOT_PORTED` maps a qualified name of `imagepipe_tpu` (relative to the
package) to the reason the port has no counterpart:

  * "kernels.develop_pallas"                 -- a module;
  * "profiling.vpu_pass_census"              -- a module-level name;
  * "sources.RasterImage.staged_planes"      -- a method;
  * "parallel.batch.BatchEngine(mesh=)"      -- a parameter of a function or
                                                method (a class: its __init__).

Every other public name of a JAX module, and every keyword of a public
function or method the two packages share, exists in the port's module of
the same name (tests/test_torch_surface.py holds both packages to this, and
each key here to a name the JAX package still has).
"""

from __future__ import annotations

_TPU_WORKAROUND = "a TPU workaround (ROADMAP 'Do not port TPU workarounds')"
_SPMD = ("the JAX package runs one SPMD program over every host's devices; each torch "
         "rank runs its own program, and ranks meet in one status gather "
         "(parallel/multihost.py)")
_MESH = ("a jax.sharding.Mesh; the port takes torch devices (`devices=`, rows of "
         "`parallel.make_batch_mesh`, `rows=` in shard_batch)")
_INTERPRET = ("Pallas interpret mode on the CPU; the port's wrappers run their plain "
              "version on CPU tensors instead")
_STAGED = ("a plane padded on the host for the TPU's 8x128 tiles; the port's kernel "
           "reads the uncropped plane")

NOT_PORTED: dict[str, str] = {
    # Modules: the port's kernels live under other names.
    "kernels.develop_pallas": "the Pallas develop kernel; the port's is kernels/develop.py "
                              "(csrc/develop.cu)",
    "kernels.rotate_pallas": "the Pallas rotate kernel; the port's is kernels/rotate.py "
                             "(csrc/rotate.cu)",
    "kernels.develop_scaled_sep": ("the separable XLA thumbnail path; the port's scaled "
                                   "kernel (kernels/develop_scaled.py) takes its plans"),
    # TPU accounting and knobs.
    "profiling.vpu_pass_census": "TPU VPU pass accounting; " + _TPU_WORKAROUND,
    "profiling.vpu_floor_ms": "TPU VPU floor from the pass census; " + _TPU_WORKAROUND,
    "scaling.USE_ROTATE_PALLAS": ("the switch between the Pallas rotate kernel and XLA; the "
                                  "port routes by device (kernel on CUDA, plain version on "
                                  "the CPU)"),
    "kernels.develop_scaled.BATCH_GRID": ("the Pallas batch-in-the-grid switch; the port's "
                                          "batch is always blockIdx.z of one launch"),
    "kernels.develop_scaled.TC": "the Pallas output tile's 128 lanes; " + _TPU_WORKAROUND,
    "kernels.develop_scaled.stage_scaled_np": _STAGED + "; " + _TPU_WORKAROUND,
    "kernels.develop_scaled.staged_scaled_cached": ("the device cache of stage_scaled_np's "
                                                    "padded plane; " + _TPU_WORKAROUND),
    # jax.numpy staging of host planes.
    "sources.staged_raw_plane": ("jax.numpy staging the port's copy of sources.py leaves "
                                 "out; planes reach the card through kernels/library.upload"),
    "sources.RasterImage.staged_planes": ("jax.numpy staging the port's copy of sources.py "
                                          "leaves out; rasters reach the card through "
                                          "ops/gofloat.raster_planes"),
    # The multihost SPMD helpers.
    "parallel.global_batch_mesh": _SPMD,
    "parallel.multihost.global_batch_mesh": _SPMD,
    "parallel.multihost._make_global": _SPMD,
    "parallel.multihost._allgather_i32": _SPMD,
    # Parameters.
    "parallel.batch.BatchEngine(mesh=)": _MESH,
    "parallel.batch.shard_batch(mesh=)": _MESH,
    "parallel.multihost.MultiHostBatchEngine(mesh=)": _MESH,
    "kernels.develop_scaled.develop_scaled(interpret=)": _INTERPRET,
    "kernels.develop_scaled.develop_scaled(staged=)": _STAGED,
    "kernels.develop_scaled.develop_scaled_batch(interpret=)": _INTERPRET,
    "kernels.develop_scaled.develop_scaled_batch(staged=)": _STAGED,
    "kernels.develop_scaled.develop_scaled_batch(plan=)": (
        "the port's takes `plans`, one per image (the shape class's statics and each "
        "image's calibration), where the JAX function takes one `plan` and optional "
        "`param_plans`"),
    "kernels.develop_scaled.develop_scaled_batch(param_plans=)": (
        "folded into the port's `plans` (see develop_scaled_batch(plan=))"),
    "color.TransformLUT(jnp_transform=)": ("a jax.numpy function; the port's TransformLUT "
                                           "takes torch functions, `direct=`"),
    "color.TransformLUT(jnp_reference=)": ("a jax.numpy function; the port's TransformLUT "
                                           "takes torch functions, `reference=`"),
}

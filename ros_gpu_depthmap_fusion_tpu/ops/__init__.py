"""Device op set.

One module per reference GLSL-kernel family (SURVEY.md §2.3):

==============================  ==============================================
reference kernel                device op
==============================  ==============================================
convert_depthmap_to_points      :mod:`.unproject`
filter_flying_pixels            :mod:`.stencil` (2-D reference);
                                :mod:`.flying_pixels` (Triton kernel on CUDA)
filter_point_sequence           :mod:`.stencil` (1-D)
crop_points                     :mod:`.mask_ops.crop_points`
apply_point_mask                :mod:`.mask_ops.compact` (deterministic)
compute_voxel_coords            :meth:`core.grid.VoxelGrid.cell_index_clamped`
voxel_grid_occupancy_of_points  :mod:`.voxel.scatter_occupancy`
zero/set/decrement/max/add      :mod:`.voxel` fused elementwise
uints_to_chars etc.             :mod:`.pack`
transfer_data(_from)            jnp take / dynamic_update_slice (no module)
transform_points(_indirect)     :mod:`core.transforms`
radix sort / groupers           :mod:`.voxelize.sort_by_key/group_by_key`
voxelize.h average/occupied     :mod:`.voxelize`
layers_connections              :mod:`.segmentation` (mapping package)
rollbuffer_* kernels            :mod:`state.rollbuffer`
==============================  ==============================================
"""

from ros_gpu_depthmap_fusion_tpu.ops import (  # noqa: F401
    mask_ops,
    pack,
    radius,
    stencil,
    unproject,
    voxel,
    voxelize,
)

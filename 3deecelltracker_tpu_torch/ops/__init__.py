"""The operator library: filters, LCN, tiling, EDT, peaks, connected
components, watershed, segment reductions, kNN, matching, PR-GLS,
subregions, the trimmed mean, rays, NMS and StarDist's ground truth, with
the Hopper kernels' wrappers (``hopper_conv``, ``hopper_flood``,
``hopper_cc``, ``ladder``).  Exported here as the JAX package's
``ops/__init__.py`` exports them: ``ops.lcn`` is the function, as there;
its module is imported by its dotted path (``from ..ops.lcn import
...``)."""

from .filters import box_sum, box_mean, gaussian_filter, uniform_filter
from .lcn import lcn, normalize_image, normalize_label
from .tiling import plan_tiles, extract_tiles, stitch_tiles, tiled_apply
from .edt import distance_transform_edt
from .peaks import peak_local_max_mask
from .connected import (label_components, label_components_raw,
                        label_components_values, relabel_sequential)
from .watershed import (watershed_flood, watershed_2d, watershed_3d,
                        recalculate_cell_boundaries, find_boundaries_outer,
                        remove_small_objects)
from .segment_reduce import (center_of_mass, label_counts,
                             find_objects_bounds, topq_mean_intensity)
from .knn import knn, knn_feature_vectors, knn_feature_vectors_cross, \
    pairwise_sq_dists
from .pointset import normalize_points
from .matching import (simple_match, legacy_init_match, softmax_normalize,
                       row_wise_normalize, non_max_suppression_normalize)
from .prgls import (prgls_quick, prgls_with_two_ref, pr_gls_quick,
                    gaussian_gram)
from .subregions import (SubregionAtlas, build_subregion_atlas,
                         move_cells_full, move_cells_sampled)
from .trim import trim_mean
from .rays import rays_golden_spiral, polyhedron_volumes
from .nms import greedy_nms, overlap_matrix, render_polyhedra_labels
from .stardist_gt import star_dist3d, edt_prob

__all__ = [
    "box_sum", "box_mean", "gaussian_filter", "uniform_filter",
    "lcn", "normalize_image", "normalize_label",
    "plan_tiles", "extract_tiles", "stitch_tiles", "tiled_apply",
    "distance_transform_edt", "peak_local_max_mask",
    "label_components", "label_components_raw", "label_components_values",
    "relabel_sequential",
    "watershed_flood", "watershed_2d", "watershed_3d",
    "recalculate_cell_boundaries", "find_boundaries_outer",
    "remove_small_objects",
    "center_of_mass", "label_counts", "find_objects_bounds",
    "topq_mean_intensity",
    "knn", "knn_feature_vectors", "knn_feature_vectors_cross",
    "pairwise_sq_dists", "normalize_points",
    "simple_match", "legacy_init_match", "softmax_normalize",
    "row_wise_normalize", "non_max_suppression_normalize",
    "prgls_quick", "prgls_with_two_ref", "pr_gls_quick", "gaussian_gram",
    "SubregionAtlas", "build_subregion_atlas", "move_cells_full",
    "move_cells_sampled", "trim_mean",
    "rays_golden_spiral", "polyhedron_volumes",
    "greedy_nms", "overlap_matrix", "render_polyhedra_labels",
    "star_dist3d", "edt_prob",
]

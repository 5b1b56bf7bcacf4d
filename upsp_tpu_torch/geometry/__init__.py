"""Surface models and the numpy BVH layout: copies of
``upsp_tpu/geometry/grids.py`` and ``bvh.py`` (numpy and scipy only)."""

"""The port's kernels: plain torch oracles (``ref``), the two hand-written
CUDA kernels with their plain versions (``fused_scan``,
``gather_distance``) and the segmented search built on them (``ops``)."""

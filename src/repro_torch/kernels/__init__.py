"""The port's kernels: plain torch oracles (``ref``), the four hand-written
CUDA kernels with their plain versions (``fused_scan``,
``gather_distance``, ``masked_distance``, ``filtered_topk``) and the
searches built on them (``ops``)."""

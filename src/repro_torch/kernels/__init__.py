"""The port's kernels: plain torch oracles (``ref``), the hand-written CUDA
kernels with their plain versions (``fused_scan``, ``gather_distance``
(the segmented arena gather and the graph's per-hop gather),
``masked_distance``, ``filtered_topk``, ``flash_decode``, ``graph_walk``:
the graph's beam search, a walk a query lane) and the searches built on
them (``ops``)."""

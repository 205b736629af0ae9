"""The port's measurement entry points on the card (counterparts of the
repo-root ``benchmarks/``): ``timing`` (the shared protocol), ``flops``
(operation and byte counts, H100 peaks), ``roofline_fused`` (K2's roofline
with K5's sin rate) and ``prof_trajqp_fused`` (K4 against the scan IPM)."""

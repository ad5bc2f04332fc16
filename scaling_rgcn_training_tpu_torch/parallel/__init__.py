"""Multi-device training over a mesh: the edge partition (partial sums
added across shards) and the halo partition (node ranges, boundary rows
exchanged by an all-to-all), with the halo-exchange and fused
halo-aggregate kernels (#6, #7)."""

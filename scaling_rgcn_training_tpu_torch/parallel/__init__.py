"""Multi-device training over a mesh: the edge partition (partial sums
added across shards) and the halo partition (node ranges, boundary rows
exchanged by an all-to-all), with the halo-exchange and fused
halo-aggregate kernels (#6, #7); the halo partition also across processes
over ``torch.distributed``, #6 and #7 reading other processes' rows
through CUDA IPC (``ipc.py``)."""

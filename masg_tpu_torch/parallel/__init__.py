"""Data parallelism over torch.distributed (port of masg_tpu/parallel/):
`distributed` joins and spawns process groups and holds the collectives,
`mesh` the data axis the trainers and the serving engine shard over."""

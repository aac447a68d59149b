"""Data and tensor parallelism over torch.distributed (port of
masg_tpu/parallel/): `distributed` joins and spawns process groups and holds
the collectives, `tensor` the model axis's operators, `mesh` the (data,
model) mesh the trainers and the serving engine shard over."""

"""The multi-card path on torch.distributed: the (data, model) mesh, the
model-sharded index, the distributed MEM and serving steps, the cross-card
tag merge (the counterpart of pangenome_index_tpu/parallel/)."""

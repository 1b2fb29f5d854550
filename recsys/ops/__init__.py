"""Device ops in plain JAX: graph propagation, the in-batch contrastive
loss family, FM interactions, IVF and int8 retrieval. XLA compiles each
for whatever backend JAX runs on; there is no per-platform dispatch."""

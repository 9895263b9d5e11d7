"""Tensor, sequence, expert and pipeline parallel decode, their tp x ep and
tp x sp compositions, and the multi-process runtime, on torch.distributed
(the port of the JAX package's effort_tpu/parallel/).

One process a rank (multihost.spawn starts local ones); a mesh is a
DeviceMesh with the JAX package's axis names, and collectives.py holds the
counterparts of the jax.lax collectives."""

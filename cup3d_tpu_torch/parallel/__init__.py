"""Sharding on one device (port of ``cup3d_tpu/parallel``): the
block-sharded AMR forest (D shards of the block axis, with their halo
exchange), the ring transport (kernel B14), the uniform grid's x-slab
padding, and the meshes and collectives of the x-slab megaloop
(mesh.py, topology.py, collectives.py).  The shards live on one device
as a leading batch axis; see parallel/compat.py."""

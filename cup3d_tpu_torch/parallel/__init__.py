"""The block-sharded AMR forest (port of ``cup3d_tpu/parallel``'s forest
layer): D shards of the block axis, with their halo exchange and the
ring transport (kernel B14).  The shards live on one device as a leading
batch axis; see parallel/compat.py."""

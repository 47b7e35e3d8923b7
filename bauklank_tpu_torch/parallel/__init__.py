"""Process-group meshes and stream sharding for many cards
(``torch.distributed``; one rank per card)."""

from bauklank_tpu_torch.parallel.mesh import shard_streams, sharded_step, stream_mesh

__all__ = ["stream_mesh", "shard_streams", "sharded_step"]

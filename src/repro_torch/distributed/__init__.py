"""Distribution substrate: sharding rules, placement on a device mesh
(:mod:`.placement`), checkpointing, compression, failure handling (twin of
``repro.distributed``)."""
from repro_torch.distributed.sharding import (ShardingRules, DEFAULT_RULES,
                                              spec_for, params_shardings,
                                              batch_sharding, tree_shardings)
from repro_torch.distributed.checkpoint import (save_checkpoint,
                                                restore_checkpoint,
                                                latest_step)
from repro_torch.distributed.compression import (compress_int8,
                                                 decompress_int8,
                                                 CompressionState,
                                                 compressed_gradients)

__all__ = [
    "ShardingRules", "DEFAULT_RULES", "spec_for", "params_shardings",
    "batch_sharding", "tree_shardings", "save_checkpoint",
    "restore_checkpoint", "latest_step", "compress_int8", "decompress_int8",
    "CompressionState", "compressed_gradients",
]

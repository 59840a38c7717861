"""Multi-device execution of the port: data parallelism, multi-process
input and row-sharded (halo-exchange) inference."""

from segtpu_torch.core.dist import create_mesh
from segtpu_torch.parallel.data_parallel import (DataParallel,
                                                 replicate_state, shard_batch,
                                                 shard_loader)
from segtpu_torch.parallel.multihost import (global_batch_from_local,
                                             process_local_slice)
from segtpu_torch.parallel.spatial import (make_spatial_sharded_predictor,
                                           spatial_predict)

__all__ = ["DataParallel", "create_mesh", "global_batch_from_local",
           "make_spatial_sharded_predictor", "process_local_slice",
           "replicate_state", "shard_batch", "shard_loader",
           "spatial_predict"]

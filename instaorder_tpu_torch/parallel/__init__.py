from .mesh import (DATA_AXIS, data_rank, init_data_parallel, init_from_env,
                   make_mesh, shard_batch)
from .collectives import (all_gather_cat, all_reduce_mean, broadcast_tree,
                          gather_tensors, gather_tensors_batch,
                          process_allgather)

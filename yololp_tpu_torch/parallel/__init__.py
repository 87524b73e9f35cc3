"""Multi-GPU: process groups and data-parallel helpers (parallel/mesh.py),
sharded inference (parallel/infer.py), the (data, spatial) mesh and its
shardings (parallel/mesh.py) and the height-sharded forward over it
(parallel/spatial.py); counterpart of yololp_tpu/parallel/."""

from yololp_tpu_torch.parallel.mesh import (Sharding, band_rows, barrier, broadcast_, data_mesh,
                                            data_sharding, data_spatial_mesh, global_sum,
                                            global_sum_grad, image_sharding,
                                            initialize_distributed, is_main_process, local_rank,
                                            rank, replicated, shard_dataset_indices, world_size)

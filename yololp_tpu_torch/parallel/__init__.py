"""Multi-GPU: process groups and data-parallel helpers (parallel/mesh.py)
and sharded inference (parallel/infer.py); counterpart of
yololp_tpu/parallel/."""

from yololp_tpu_torch.parallel.mesh import (barrier, broadcast_, data_mesh, global_sum,
                                            global_sum_grad, initialize_distributed,
                                            is_main_process, local_rank, rank,
                                            shard_dataset_indices, world_size)
